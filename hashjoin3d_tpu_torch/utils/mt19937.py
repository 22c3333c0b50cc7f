"""Pure-Python twin of the native generator: std::mt19937 + libstdc++
distribution protocols.

Port (a copy: the module is plain Python and numpy) of
``hashjoin3d_tpu/utils/mt19937.py``.  The native library (the port's
``hashjoin3d_tpu_torch/native/hj3gen.cpp``) is the authoritative bit-exact
source of benchmark inputs; this module reproduces the same streams in Python
for environments without a C++ toolchain.  It implements:

* the MT19937 engine (default seed 5489, standard seeding recurrence);
* libstdc++'s ``uniform_int_distribution`` single-draw downscaling protocol;
* libstdc++'s ``std::shuffle`` (including the paired-swap optimization used
  for ranges <= 65535, where one 32-bit draw yields two swap positions);
* ``generate_canonical<double>`` (two draws combined) for the zipf sampler's
  ``uniform_real_distribution``;
* the rejection-inversion zipf sampler (Hoermann & Derflinger 1996) with the
  same numerical formulation as ``util/zipf_distribution.hh:89-130``.

Tested for bit-equality against the native library
(tests/test_torch_utils.py).
"""

from __future__ import annotations

import math

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_U32 = 0xFFFFFFFF


class MT19937:
    """The standard 32-bit Mersenne Twister engine (as std::mt19937)."""

    def __init__(self, seed: int = 5489):
        self.mt = np.zeros(_N, np.uint64)
        self.mt[0] = seed & _U32
        for i in range(1, _N):
            self.mt[i] = (
                1812433253 * (int(self.mt[i - 1]) ^ (int(self.mt[i - 1]) >> 30)) + i
            ) & _U32
        self.idx = _N
        self._buf = None
        self._bufpos = 0

    def _twist(self):
        # The twist updates in place, and entries i >= N-M read entries already
        # rewritten earlier in the same pass -- so vectorize in three stages.
        mt = self.mt

        def mix(y):
            mag = np.where((y & np.uint64(1)).astype(bool), _MATRIX_A, 0).astype(
                np.uint64
            )
            return (y >> np.uint64(1)) ^ mag

        # stage 1: i in [0, N-M): all reads are old state
        y = (mt[: _N - _M] & np.uint64(_UPPER)) | (
            mt[1 : _N - _M + 1] & np.uint64(_LOWER)
        )
        mt[: _N - _M] = mt[_M:_N] ^ mix(y)
        # stage 2: i in [N-M, N-1): mt[i+M-N] was rewritten earlier in the same
        # pass -- by stage 1 for i < 2(N-M), by stage 2 itself beyond that (the
        # dependency lag is N-M), so process in chunks of N-M.
        start = _N - _M
        while start < _N - 1:
            end = min(start + (_N - _M), _N - 1)
            y = (mt[start:end] & np.uint64(_UPPER)) | (
                mt[start + 1 : end + 1] & np.uint64(_LOWER)
            )
            mt[start:end] = mt[start - (_N - _M) : end - (_N - _M)] ^ mix(y)
            start = end
        # stage 3: i = N-1: wraps to the new mt[0]
        y = (mt[_N - 1] & np.uint64(_UPPER)) | (mt[0] & np.uint64(_LOWER))
        mt[_N - 1] = mt[_M - 1] ^ mix(y)

        self.mt = mt & np.uint64(_U32)
        self.idx = 0

    def block(self) -> np.ndarray:
        """One full tempered output block of 624 uint32 values."""
        if self.idx >= _N:
            self._twist()
        y = self.mt[self.idx:].astype(np.uint64)
        self.idx = _N
        y = y ^ (y >> np.uint64(11))
        y = y ^ ((y << np.uint64(7)) & np.uint64(0x9D2C5680))
        y = y ^ ((y << np.uint64(15)) & np.uint64(0xEFC60000))
        y = y ^ (y >> np.uint64(18))
        return (y & np.uint64(_U32)).astype(np.uint32)

    def __call__(self) -> int:
        if self._buf is None or self._bufpos >= len(self._buf):
            self._buf = self.block()
            self._bufpos = 0
        v = int(self._buf[self._bufpos])
        self._bufpos += 1
        return v

    def stream(self, n: int) -> np.ndarray:
        out = np.empty(n, np.uint32)
        for i in range(n):
            out[i] = self()
        return out


# -- libstdc++ uniform_int_distribution single-draw protocol -------------------

def std_uniform_int(rng: MT19937, a: int, b: int) -> int:
    """uniform int in [a, b] via libstdc++'s (GCC >= 11) protocol.

    For a generator producing exactly 32 bits (mt19937), libstdc++ downscales
    with Lemire's nearly-divisionless algorithm ("Fast Random Integer
    Generation in an Interval", TOMACS 2019): take the high 32 bits of
    draw * range, rejecting only when the low half falls under
    (2**32 - range) % range.
    """
    urange = b - a
    if urange == _U32:  # full generator range: raw draw
        return a + rng()
    if urange > _U32:
        raise NotImplementedError("urange > generator range")
    uerange = urange + 1
    product = rng() * uerange
    low = product & _U32
    if low < uerange:
        threshold = (0x1_0000_0000 - uerange) % uerange
        while low < threshold:
            product = rng() * uerange
            low = product & _U32
    return a + (product >> 32)


# -- libstdc++ std::shuffle -----------------------------------------------------

def std_shuffle(arr: np.ndarray, rng: MT19937) -> None:
    """In-place shuffle matching libstdc++'s std::shuffle draw sequence.

    When the range*range fits the generator range (n <= 65535), libstdc++
    generates two swap positions from a single 32-bit draw per pair of
    elements; otherwise it Fisher-Yates with one 64-bit-typed uniform_int
    draw per element.
    """
    n = len(arr)
    if n <= 1:
        return
    urngrange = _U32
    if urngrange // n >= n:  # paired-swap fast path
        i = 1
        if n % 2 == 0:
            j = std_uniform_int(rng, 0, 1)
            arr[i], arr[j] = arr[j], arr[i]
            i += 1
        while i < n:
            swap_range = i + 1
            # __gen_two_uniform_ints(swap_range, swap_range+1, g)
            x = std_uniform_int(rng, 0, swap_range * (swap_range + 1) - 1)
            p0, p1 = x // (swap_range + 1), x % (swap_range + 1)
            arr[i], arr[p0] = arr[p0], arr[i]
            i += 1
            arr[i], arr[p1] = arr[p1], arr[i]
            i += 1
    else:
        for i in range(n - 1, 0, -1):
            j = std_uniform_int(rng, 0, i)
            arr[i], arr[j] = arr[j], arr[i]


# -- libstdc++ generate_canonical<double> + uniform_real ------------------------

_R = 4294967296.0       # generator range as double
_R2 = _R * _R


def generate_canonical(rng: MT19937) -> float:
    """Double in [0,1) from two 32-bit draws, as libstdc++ generate_canonical."""
    s = float(rng())
    s += float(rng()) * _R
    ret = s / _R2
    if ret >= 1.0:
        ret = math.nextafter(1.0, 0.0)
    return ret


def std_uniform_real(rng: MT19937, a: float, b: float) -> float:
    return generate_canonical(rng) * (b - a) + a


class StdExponential:
    """libstdc++ ``std::exponential_distribution<double>`` replica.

    ``-log(1 - U)/lambda`` with U from :func:`generate_canonical` -- same
    draw protocol, so streams are bit-identical to the native generator.
    """

    def __init__(self, lambd: float):
        self.lambd = lambd

    def __call__(self, rng: MT19937) -> float:
        return -math.log(1.0 - generate_canonical(rng)) / self.lambd


class StdNormal:
    """libstdc++ ``std::normal_distribution<double>`` replica.

    Marsaglia polar method with the saved-deviate cache, reproducing
    libstdc++'s exact draw order and accept condition (``r2 > 1 or r2 == 0``
    rejects; returns ``y*mult`` first, caches ``x*mult``).
    """

    def __init__(self, mean: float, stddev: float):
        self.mean = mean
        self.stddev = stddev
        self._saved = 0.0
        self._saved_available = False

    def __call__(self, rng: MT19937) -> float:
        if self._saved_available:
            self._saved_available = False
            ret = self._saved
        else:
            while True:
                x = 2.0 * generate_canonical(rng) - 1.0
                y = 2.0 * generate_canonical(rng) - 1.0
                r2 = x * x + y * y
                if not (r2 > 1.0 or r2 == 0.0):
                    break
            mult = math.sqrt(-2.0 * math.log(r2) / r2)
            self._saved = x * mult
            self._saved_available = True
            ret = y * mult
        return ret * self.stddev + self.mean


class StdPoisson:
    """libstdc++ ``std::poisson_distribution<int>`` replica.

    Two regimes, as in GCC's ``bits/random.tcc`` (``_M_initialize`` +
    ``operator()``):

    * mean < 12: product-of-uniforms (count draws until the running product
      of canonicals falls below ``exp(-mean)``);
    * mean >= 12: Devroye's rejection method (Non-Uniform Random Variate
      Generation, 1986, Ch. X §3.3-3.4 + errata) with libstdc++'s exact
      constants, case thresholds and draw order -- including its private
      ``normal_distribution<double>`` member (Marsaglia polar, with the
      saved-deviate cache persisting across calls).

    Streams are bit-identical to the native generator / the reference's
    ``genval_pois`` (``util/GenRandIntVec.cc``, pois case); pinned by
    tests/test_generators.py.
    """

    def __init__(self, mean: float):
        self.mean = mean
        self._nd = StdNormal(0.0, 1.0)  # _M_nd: persists across calls
        if mean >= 12:
            m = math.floor(mean)
            self._m = m
            self._lm_thr = math.log(mean)
            self._lfm = math.lgamma(m + 1)
            self._sm = math.sqrt(m)
            pi_4 = 0.7853981633974483096156608458198757
            dx = math.sqrt(2 * m * math.log(32 * m / pi_4))
            self._d = round_half_away(max(6.0, min(m, dx)))
            cx = 2 * m + self._d
            self._scx = math.sqrt(cx / 2)
            self._1cx = 1 / cx
            self._c2b = math.sqrt(pi_4 * cx) * math.exp(self._1cx)
            self._cb = (2 * cx * math.exp(-self._d * self._1cx
                                          * (1 + self._d / 2)) / self._d)
        else:
            self._lm_thr = math.exp(-mean)

    def __call__(self, rng: MT19937) -> int:
        if self.mean < 12:
            x = 0
            prod = 1.0
            while True:
                prod *= generate_canonical(rng)
                x += 1
                if not prod > self._lm_thr:
                    break
            return x - 1

        naf = (1 - 2.220446049250313e-16) / 2  # (1 - DBL_EPSILON) / 2
        thr = 2147483647 + naf                  # numeric_limits<int>::max()
        m = self._m
        spi_2 = 1.2533141373155002512078826424055226  # sqrt(pi / 2)
        c1 = self._sm * spi_2
        c2 = self._c2b + c1
        c3 = c2 + 1
        c4 = c3 + 1
        k178 = 0.0128205128205128205128205128205128   # 1 / 78
        e178 = 1.0129030479320018583185514777512983   # e^(1/78)
        c5 = c4 + e178
        c = self._cb + c5
        two_cx = 2 * (2 * m + self._d)

        while True:
            u = c * generate_canonical(rng)
            e = -math.log(1.0 - generate_canonical(rng))
            w = 0.0
            if u <= c1:
                n = self._nd(rng)
                y = -abs(n) * self._sm - 1
                x = math.floor(y)
                w = -n * n / 2
                if x < -m:
                    continue
            elif u <= c2:
                n = self._nd(rng)
                y = 1 + abs(n) * self._scx
                x = math.ceil(y)
                w = y * (2 - y) * self._1cx
                if x > self._d:
                    continue
            elif u <= c3:
                x = -1.0
            elif u <= c4:
                x = 0.0
            elif u <= c5:
                x = 1.0
                w = k178  # errata case, libstdc++/83237
            else:
                v = -math.log(1.0 - generate_canonical(rng))
                y = self._d + v * two_cx / self._d
                x = math.ceil(y)
                w = -self._d * self._1cx * (1 + y / 2)

            reject = (w - e - x * self._lm_thr
                      > self._lfm - math.lgamma(x + m + 1))
            reject |= x + m >= thr
            if not reject:
                return int(x + m + naf)


# -- zipf sampler (same numerics as the reference's, see module docstring) ------

_EPS = 1e-8


def _expxm1bx(x: float) -> float:
    if abs(x) > _EPS:
        return math.expm1(x) / x
    return 1.0 + x / 2.0 * (1.0 + x / 3.0 * (1.0 + x / 4.0))


def _log1pxbx(x: float) -> float:
    if abs(x) > _EPS:
        return math.log1p(x) / x
    return 1.0 - x * ((1 / 2.0) - x * ((1 / 3.0) - x * (1 / 4.0)))


class ZipfSampler:
    """Rejection-inversion zipf over [1, n] (Hoermann & Derflinger 1996)."""

    def __init__(self, n: int, q: float):
        self.n = n
        self.q = q
        self.H_x1 = self._H(1.5) - 1.0
        self.H_n = self._H(n + 0.5)

    def _H(self, x: float) -> float:
        lx = math.log(x)
        return _expxm1bx((1.0 - self.q) * lx) * lx

    def _H_inv(self, x: float) -> float:
        t = max(-1.0, x * (1.0 - self.q))
        return math.exp(_log1pxbx(t) * x)

    def _h(self, x: float) -> float:
        return math.exp(-self.q * math.log(x))

    def __call__(self, rng: MT19937) -> int:
        while True:
            u = std_uniform_real(rng, self.H_x1, self.H_n)
            x = self._H_inv(u)
            # std::round then clamp to [1, n]
            k = int(min(max(round_half_away(x), 1), self.n))
            if u >= self._H(k + 0.5) - self._h(k):
                return k


    # probability mass / cumulative distribution (reference additions,
    # util/zipf_distribution.hh:60-77)
    def pmf(self, k: int) -> float:
        assert 1 <= k <= self.n
        if not hasattr(self, "_pmf_denom"):
            self._pmf_denom = 1.0 / sum(1.0 / i ** self.q
                                        for i in range(1, self.n + 1))
        return (1.0 / k ** self.q) * self._pmf_denom

    def cdf(self, k: int) -> float:
        assert 1 <= k <= self.n
        return sum(self.pmf(i) for i in range(1, k + 1))


def round_half_away(x: float) -> int:
    """C++ std::round: half away from zero (Python's round is half-to-even)."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))
