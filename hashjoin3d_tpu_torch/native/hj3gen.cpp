// hj3gen: host-side synthetic data generation for hashjoin3d_tpu.
//
// The TPU engine's benchmark inputs must be bit-identical to the reference
// experiments' inputs so result sets can be compared exactly (SURVEY.md
// sections 5.4, 7.4).  The reference generates data with a default-seeded
// std::mt19937 and libstdc++ distributions (main_experiment1.cc:415-457,
// main_experiment4.cc:517-575, util/GenRandIntVec.cc, util/zipf_distribution.hh).
// Those distribution algorithms are implementation-defined, so the only robust
// way to reproduce the exact streams is to call the same libstdc++ facilities
// in the same order -- which is what this C++ library does.  It exposes a C ABI
// consumed from Python via ctypes (hashjoin3d_tpu/utils/gen.py).
//
// This is new code: it reproduces the reference's *generation protocol*
// (documented behavior), not its source.
//
// Build:  g++ -O2 -std=c++20 -shared -fPIC -o libhj3gen.so hj3gen.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <random>
#include <unordered_set>
#include <vector>

namespace {

using rng_t = std::mt19937;

// ---------------------------------------------------------------------------
// Zipf sampler over [1, n]: rejection-inversion after Hoermann & Derflinger,
// "Rejection-inversion to generate variates from monotone discrete
// distributions", ACM TOMACS 6.3 (1996).  The numerical formulation (series
// fallbacks for |x| <= 1e-8) matches the reference's sampler
// (util/zipf_distribution.hh:89-130) so the accept/reject decisions -- and
// therefore the consumed rng stream -- are identical.
// ---------------------------------------------------------------------------
class ZipfSampler {
 public:
  ZipfSampler(uint64_t n, double q)
      : n_(n),
        q_(q),
        H_x1_(H(1.5) - 1.0),
        H_n_(H(n + 0.5)),
        dist_(H_x1_, H_n_) {}

  uint64_t operator()(rng_t& rng) {
    for (;;) {
      const double u = dist_(rng);
      const double x = H_inv(u);
      uint64_t k = static_cast<uint64_t>(std::llround(x));
      if (k < 1) k = 1;
      if (k > n_) k = n_;
      if (u >= H(k + 0.5) - h(k)) return k;
    }
  }

 private:
  static constexpr double kEps = 1e-8;

  // (exp(x) - 1) / x with a Taylor fallback near 0.
  static double expxm1bx(double x) {
    if (std::abs(x) > kEps) return std::expm1(x) / x;
    return 1.0 + x / 2.0 * (1.0 + x / 3.0 * (1.0 + x / 4.0));
  }

  // log(1 + x) / x with a Taylor fallback near 0.
  static double log1pxbx(double x) {
    if (std::abs(x) > kEps) return std::log1p(x) / x;
    return 1.0 - x * ((1 / 2.0) - x * ((1 / 3.0) - x * (1 / 4.0)));
  }

  double H(double x) const {
    const double lx = std::log(x);
    return expxm1bx((1.0 - q_) * lx) * lx;
  }

  double H_inv(double x) const {
    const double t = std::max(-1.0, x * (1.0 - q_));
    return std::exp(log1pxbx(t) * x);
  }

  double h(double x) const { return std::exp(-q_ * std::log(x)); }

  uint64_t n_;
  double q_;
  double H_x1_, H_n_;
  std::uniform_real_distribution<double> dist_;
};

// ---------------------------------------------------------------------------
// GenRandIntVec-compatible column generator (util/GenRandIntVec.{hh,cc}).
// dist codes match the reference enum order: 0=key 1=div 2=uni 3=exp 4=norm
// 5=zipf 6=self 7=pois (GenRandIntVec.hh:24-34).
// flags: 1=fill (every value at least once), 2=shuffle (permute the frequency
// vector).  order: -1 permute, 0 none, +1 sort.
// ---------------------------------------------------------------------------
enum Dist { kKey = 0, kDiv, kUni, kExp, kNorm, kZipf, kSelf, kPois };
enum Flags { kFill = 1, kShuffle = 2 };

// In-place Fisher-Yates variant with the reference's exact draw pattern
// (GenRandIntVec.cc:335-340: swap(v[i], v[rng() % i]) for i = n-1 .. 1).
void permute_like_reference(std::vector<uint32_t>& v, rng_t& rng) {
  for (size_t i = v.size() - 1; i > 0; --i) {
    std::swap(v[i], v[rng() % i]);
  }
}

void freq_expand(std::vector<uint32_t>& out, const std::vector<uint32_t>& freq) {
  size_t k = 0;
  for (size_t val = 0; val < freq.size(); ++val) {
    for (uint32_t j = 0; j < freq[val]; ++j) out[k++] = static_cast<uint32_t>(val);
  }
}

struct GenParams {
  int dist;
  int64_t maxv;    // exclusive upper bound of the value domain
  int64_t shift;
  double param;    // lambda / stddev / zipf exponent / self-similar h
  int flags;
  int order;       // -1 permute, 0 none, +1 sort
};

// One value from each parametric distribution, consuming rng exactly like the
// reference's genval_* helpers (GenRandIntVec.cc:271-332).
struct ValueGens {
  std::exponential_distribution<double> exp_d;
  std::normal_distribution<double> norm_d;
  std::poisson_distribution<int> pois_d;

  uint32_t exp_val(const GenParams& p, rng_t& rng) {
    return static_cast<uint32_t>(
        (static_cast<int64_t>(std::floor(exp_d(rng) * p.maxv + p.shift))) % p.maxv);
  }
  uint32_t norm_val(const GenParams& p, rng_t& rng) {
    for (;;) {
      const double v = norm_d(rng);
      if (0 <= v && v < static_cast<double>(p.maxv)) {
        return static_cast<uint32_t>((static_cast<int64_t>(v) + p.shift) % p.maxv);
      }
    }
  }
  static uint32_t self_val(const GenParams& p, rng_t& rng) {
    const double n = static_cast<double>(p.maxv);
    const double h = p.param;
    const double u = static_cast<double>(rng()) /
                     static_cast<double>(std::numeric_limits<uint32_t>::max());
    return static_cast<uint32_t>(
        static_cast<int64_t>(n * std::pow(u, std::log(h) / std::log(1.0 - h))));
  }
  uint32_t pois_val(const GenParams& p, rng_t& rng) {
    return static_cast<uint32_t>((pois_d(rng) + p.shift) % p.maxv);
  }
};

void gen_int_vec(std::vector<uint32_t>& v, uint64_t card, const GenParams& p,
                 rng_t& rng) {
  v.resize(card);
  ValueGens g;
  g.exp_d = std::exponential_distribution<double>(p.param);
  g.norm_d =
      std::normal_distribution<double>(static_cast<double>(p.maxv) / 2, p.param);
  g.pois_d = std::poisson_distribution<int>(p.param);

  const bool fill = p.flags & kFill;
  const bool shuf = p.flags & kShuffle;

  auto finish = [&](void) {
    if (p.order < 0) {
      permute_like_reference(v, rng);
    } else if (p.order > 0) {
      std::sort(v.begin(), v.end());
    }
  };

  switch (p.dist) {
    case kKey: {
      std::iota(v.begin(), v.end(), 0u);
      finish();
      return;
    }
    case kDiv: {
      const uint32_t d = static_cast<uint32_t>(p.param);
      for (uint64_t i = 0; i < card; ++i) v[i] = static_cast<uint32_t>(i / d);
      finish();
      return;
    }
    default:
      break;
  }

  // Parametric distributions share one protocol (GenRandIntVec.cc:71-268):
  // either draw per element, or (fill/shuffle) accumulate a frequency vector
  // over the domain and expand it.
  auto draw = [&](void) -> uint32_t {
    switch (p.dist) {
      case kUni: {
        std::uniform_int_distribution<int> d(0, static_cast<int>(p.maxv) - 1);
        return static_cast<uint32_t>(d(rng));
      }
      case kExp:
        return g.exp_val(p, rng);
      case kNorm:
        return g.norm_val(p, rng);
      case kSelf:
        return ValueGens::self_val(p, rng);
      case kPois:
        return g.pois_val(p, rng);
      default:
        return 0;
    }
  };

  if (p.dist == kZipf) {
    ZipfSampler zipf(static_cast<uint64_t>(p.maxv), p.param);
    if (fill || shuf) {
      std::vector<uint32_t> freq(p.maxv, 0);
      uint64_t ndraw = card;
      if (fill) {
        std::fill(freq.begin(), freq.end(), 1u);
        ndraw = card - freq.size();
      }
      for (uint64_t i = 0; i < ndraw; ++i) {
        ++freq[(zipf(rng) - 1 + p.shift) % p.maxv];
      }
      if (shuf) permute_like_reference(freq, rng);
      freq_expand(v, freq);
    } else {
      for (uint64_t i = 0; i < card; ++i) {
        v[i] = static_cast<uint32_t>((zipf(rng) - 1 + p.shift) % p.maxv);
      }
    }
    finish();
    return;
  }

  if (fill || shuf) {
    std::vector<uint32_t> freq(p.maxv, 0);
    uint64_t ndraw = card;
    if (fill) {
      std::fill(freq.begin(), freq.end(), 1u);
      ndraw = card - freq.size();
    }
    if (p.dist == kUni) {
      // The reference reuses one distribution object for the whole column.
      std::uniform_int_distribution<int> d(0, static_cast<int>(p.maxv) - 1);
      for (uint64_t i = 0; i < ndraw; ++i) ++freq[d(rng)];
    } else {
      for (uint64_t i = 0; i < ndraw; ++i) ++freq[draw()];
    }
    if (shuf && p.dist != kUni) permute_like_reference(freq, rng);
    // note: reference kUni path never shuffles the frequency vector
    // (GenRandIntVec.cc:72-98 has no vec_permute(_freq) branch for uni)
    freq_expand(v, freq);
  } else if (p.dist == kUni) {
    std::uniform_int_distribution<int> d(0, static_cast<int>(p.maxv) - 1);
    for (uint64_t i = 0; i < card; ++i) v[i] = static_cast<uint32_t>(d(rng));
  } else {
    for (uint64_t i = 0; i < card; ++i) v[i] = draw();
  }
  finish();
}

}  // namespace

extern "C" {

// --------------------------------------------------------------------------
// Experiment 1 inputs (main_experiment1.cc:415-457):
//   R.k = shuffle(iota(2^log2R));   S.a ~ uni/zipf over [0, 2^(log2R-t))
// One default-seeded mt19937 drives shuffle then FK generation, in that order.
// Returns the number of distinct values in S.a (numDvSa).
// Rk must hold 2^log2R entries, Sa 2^log2S.
// --------------------------------------------------------------------------
int64_t hj3_exp1(uint32_t log2R, uint32_t log2S, int skew, uint32_t t,
                 uint32_t* Rk, uint32_t* Sa) {
  const uint64_t cardR = 1ull << log2R;
  const uint64_t cardS = 1ull << log2S;
  const int64_t fk_max = 1ll << (log2R - t);

  rng_t rng;  // default seed 5489, as in the reference

  std::vector<uint32_t> keysR(cardR);
  std::iota(keysR.begin(), keysR.end(), 0u);
  std::shuffle(keysR.begin(), keysR.end(), rng);
  std::copy(keysR.begin(), keysR.end(), Rk);

  std::vector<uint32_t> fks;
  GenParams p{skew ? kZipf : kUni, fk_max, 0, skew ? 1.0 : 0.0, 0, -1};
  gen_int_vec(fks, cardS, p, rng);
  std::copy(fks.begin(), fks.end(), Sa);

  std::unordered_set<uint32_t> dv(fks.begin(), fks.end());
  return static_cast<int64_t>(dv.size());
}

// --------------------------------------------------------------------------
// Experiment 4 inputs (main_experiment4.cc:517-575): the inverted-star FK
// columns.  R.k and S.k/T.k are plain iotas (generated on the Python side);
// only S.a and T.a need the exact shuffle stream.  Sa and Ta must each hold
// numFkCommon*multA + numFkExclusive*multB entries.
// --------------------------------------------------------------------------
void hj3_exp4(uint32_t log2R, uint32_t alpha, uint32_t multA, uint32_t beta,
              uint32_t multB, int do_shuffle, uint32_t* Sa, uint32_t* Ta) {
  const uint64_t cardR = 1ull << log2R;
  const uint64_t numFkCommon = cardR >> alpha;
  const uint64_t numFkExclusive = cardR >> beta;

  rng_t rng;

  std::vector<uint32_t> common(numFkCommon * multA);
  std::vector<uint32_t> exclS(numFkExclusive * multB);
  std::vector<uint32_t> exclT(numFkExclusive * multB);

  uint32_t val = 0;
  size_t idx = 0;
  for (; val < numFkCommon; ++val)
    for (uint32_t i = 0; i < multA; ++i) common[idx++] = val;
  idx = 0;
  for (; val < numFkCommon + numFkExclusive; ++val)
    for (uint32_t i = 0; i < multB; ++i) exclS[idx++] = val;
  idx = 0;
  for (; val < numFkCommon + 2 * numFkExclusive; ++val)
    for (uint32_t i = 0; i < multB; ++i) exclT[idx++] = val;

  // Shuffle order matters: exclS, exclT, common -> S; common again -> T
  // (main_experiment4.cc:564-574).
  if (do_shuffle) {
    std::shuffle(exclS.begin(), exclS.end(), rng);
    std::shuffle(exclT.begin(), exclT.end(), rng);
    std::shuffle(common.begin(), common.end(), rng);
  }
  std::copy(common.begin(), common.end(), Sa);
  std::copy(exclS.begin(), exclS.end(), Sa + common.size());
  if (do_shuffle) {
    std::shuffle(common.begin(), common.end(), rng);
  }
  std::copy(common.begin(), common.end(), Ta);
  std::copy(exclT.begin(), exclT.end(), Ta + common.size());
}

// --------------------------------------------------------------------------
// Generic column generator mirroring GenRandIntVec::generate
// (GenRandIntVec.cc:22-42).  seed < 0 means "default-seeded mt19937".
// --------------------------------------------------------------------------
int hj3_gen_int_vec(int dist, uint64_t card, int64_t maxv, int64_t shift,
                    double param, int flags, int order, int64_t seed,
                    uint32_t* out) {
  if (dist < 0 || dist > kPois) return -1;
  rng_t rng;
  if (seed >= 0) rng.seed(static_cast<uint32_t>(seed));
  std::vector<uint32_t> v;
  GenParams p{dist, maxv, shift, param, flags, order};
  gen_int_vec(v, card, p, rng);
  std::copy(v.begin(), v.end(), out);
  return 0;
}

// Raw mt19937 stream (for testing the Python fallback implementation).
void hj3_mt19937_stream(int64_t seed, uint64_t n, uint32_t* out) {
  rng_t rng;
  if (seed >= 0) rng.seed(static_cast<uint32_t>(seed));
  for (uint64_t i = 0; i < n; ++i) out[i] = rng();
}

}  // extern "C"
