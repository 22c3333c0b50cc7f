"""The native host engine: C++ CSR joins with the reference's counters.

Port of ``hashjoin3d_tpu/hostengine.py``.  It wraps the port's own
byte-equal copy of the JAX package's engine source,
``hashjoin3d_tpu_torch/native/hj3engine.cpp``, compiled with ``g++`` by
``_native.build_library`` into ``hashjoin3d_tpu_torch/_build/`` at first
use (a private temporary name renamed into place, so concurrent test
workers never load a half-written library) and loaded with ``ctypes``.
Nothing of the JAX package is built, loaded or imported.

Two roles, as in the JAX package:

* the small-query path: ``join(backend="host")`` and the harnesses'
  ``backend="host"`` run here, and ``backend="auto"`` sends queries under
  ``HOST_CROSSOVER_ROWS`` here;
* a differential oracle that scales past ``tests/oracle.py``.

Counter semantics are the reference's (``ht_chaining.hh:236-248``,
``ht_nested.hh:354-382``, ``algebra.hh:625-659``).  Unlike the JAX
package, whose ``native_engine()`` returns None when the build fails and
lets its callers route to the device, :func:`native_engine` raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ._native import build_library

ENGINE_SOURCE = Path(__file__).resolve().parent / "native" / "hj3engine.cpp"

#: Registry-functor ids of the C ABI (``hj3engine.cpp`` ``HashFunId``),
#: the names of ``ops.hashing.HASH_FUNCTORS``; callable functors cannot
#: cross the ABI and stay on the device.
HASHFUN_IDS = {"murmur": 0, "boncz": 1, "fib": 2, "mult": 3, "identity": 4}

_lib = None


def _hf_id(hashfun) -> int:
    try:
        return HASHFUN_IDS[hashfun]
    except (KeyError, TypeError):
        raise ValueError(
            f"host backend supports registry hash functors "
            f"{sorted(HASHFUN_IDS)} only, got {hashfun!r}") from None


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _canon_keys(keys) -> np.ndarray:
    """A contiguous u32 or u64 key column (the engine's two
    instantiations): 8-byte input stays u64, narrower input becomes u32."""
    a = np.ascontiguousarray(keys)
    if a.dtype.itemsize == 8:
        return a.astype(np.uint64, copy=False)
    return a.astype(np.uint32, copy=False)


def _kp(a):
    return _u64p(a) if a.dtype == np.uint64 else _u32p(a)


def native_engine() -> ctypes.CDLL:
    """The engine library, built at first use; raises when ``g++`` fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = build_library(["g++", "-O3", "-std=c++20", "-shared", "-fPIC"],
                       [ENGINE_SOURCE], "hj3engine")
    lib = ctypes.CDLL(str(so))
    u32p, u64p, i32p, i64p = (ctypes.POINTER(ctypes.c_uint32),
                              ctypes.POINTER(ctypes.c_uint64),
                              ctypes.POINTER(ctypes.c_int32),
                              ctypes.POINTER(ctypes.c_int64))
    for kp, sfx in ((u32p, ""), (u64p, "64")):
        for name in ("hj3e_chaining_join", "hj3e_nested_join"):
            fn = getattr(lib, name + sfx)
            fn.restype = ctypes.c_int64
            fn.argtypes = [kp, ctypes.c_int64, kp, ctypes.c_int64,
                           ctypes.c_uint32, ctypes.c_int, i32p, i32p,
                           ctypes.c_int64, i64p, ctypes.c_uint32]
        for name in ("hj3e_chaining_create", "hj3e_nested_create"):
            fn = getattr(lib, name + sfx)
            fn.restype = ctypes.c_void_p
            fn.argtypes = [kp, ctypes.c_int64, ctypes.c_uint32,
                           ctypes.c_uint32]
        for name in ("hj3e_chaining_probe", "hj3e_nested_probe"):
            fn = getattr(lib, name + sfx)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, kp, ctypes.c_int64, ctypes.c_int,
                           i32p, i32p, ctypes.c_int64, i64p]
    lib.hj3e_table_free.restype = None
    lib.hj3e_table_free.argtypes = [ctypes.c_void_p]
    for name in ("hj3e_ndu_probe", "hj3e_chj_probe"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, u32p,
                       ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int64,
                       i64p]
    _lib = lib
    return lib


def _pair_columns(bk, pk):
    """Both key columns in one engine width: u64 when either is."""
    bk, pk = _canon_keys(bk), _canon_keys(pk)
    wide = bk.dtype == np.uint64 or pk.dtype == np.uint64
    if wide:
        bk, pk = bk.astype(np.uint64), pk.astype(np.uint64)
    return bk, pk, "64" if wide else ""


def _run(call, cap: int, n_ctr: int, exact_of, out_cap):
    """Run ``call(op, ob, cap, ctr) -> n`` into ``cap`` slots.  The
    counters are exact even when the pairs overflow: a default capacity
    retries once at the exact size, an explicit ``out_cap`` raises."""
    while True:
        op = np.empty(cap, np.int32)
        ob = np.empty(cap, np.int32)
        ctr = np.zeros(n_ctr, np.int64)
        n = call(op, ob, cap, ctr)
        if n >= 0:
            return op[:n].copy(), ob[:n].copy(), [int(x) for x in ctr]
        if out_cap is not None:
            raise ValueError(f"out_cap={cap} too small "
                             f"({exact_of(ctr)} results)")
        cap = max(exact_of(ctr), 1)


def _default_cap(out_cap, n_probe: int, n_build: int) -> int:
    return (int(out_cap) if out_cap is not None
            else max(16, 4 * n_probe + n_build))


def host_chaining_join(build_keys, probe_keys, num_buckets: int,
                       unique: bool = False, out_cap: int | None = None,
                       hashfun="murmur"):
    """Chaining hash join on the host engine: ``(probe_rows, build_rows,
    num_matches, num_cmps)``, the pair arrays trimmed to the result."""
    lib = native_engine()
    bk, pk, sfx = _pair_columns(build_keys, probe_keys)
    fn = getattr(lib, "hj3e_chaining_join" + sfx)
    hf = _hf_id(hashfun)
    op, ob, ctr = _run(
        lambda op, ob, cap, ctr: fn(_kp(bk), bk.size, _kp(pk), pk.size,
                                    num_buckets, int(unique), _i32p(op),
                                    _i32p(ob), cap, _i64p(ctr), hf),
        _default_cap(out_cap, pk.size, bk.size), 2, lambda c: int(c[0]),
        out_cap)
    return op, ob, ctr[0], ctr[1]


def host_nested_join(build_keys, probe_keys, num_buckets: int,
                     unnest: bool = True, out_cap: int | None = None,
                     hashfun="murmur"):
    """3D (nested) hash join on the host engine: ``(probe_rows,
    build_rows, num_matches, num_cmps, num_unnested)``; the pairs are the
    unnested result (empty without ``unnest``)."""
    lib = native_engine()
    bk, pk, sfx = _pair_columns(build_keys, probe_keys)
    fn = getattr(lib, "hj3e_nested_join" + sfx)
    hf = _hf_id(hashfun)
    cap = _default_cap(out_cap, pk.size, bk.size) if unnest else 1
    op, ob, ctr = _run(
        lambda op, ob, cap, ctr: fn(_kp(bk), bk.size, _kp(pk), pk.size,
                                    num_buckets, int(unnest), _i32p(op),
                                    _i32p(ob), cap, _i64p(ctr), hf),
        cap, 3, lambda c: int(c[2]), out_cap)
    return op, ob, ctr[0], ctr[1], ctr[2]


class HostTable:
    """A prebuilt engine table (the build strand), probed repeatedly.

    ``kind``: "chaining" or "nested".  The handle owns the C++ state;
    :meth:`close` frees it."""

    def __init__(self, build_keys, num_buckets: int, kind: str = "nested",
                 hashfun="murmur"):
        if kind not in ("chaining", "nested"):
            raise ValueError(f"kind must be 'chaining' or 'nested', "
                             f"got {kind!r}")
        self._lib = native_engine()
        self.kind = kind
        self.num_buckets = int(num_buckets)
        bk = _canon_keys(build_keys)
        self.key_dtype = bk.dtype
        self.n_rows = bk.size
        sfx = "64" if bk.dtype == np.uint64 else ""
        create = getattr(self._lib, f"hj3e_{kind}_create{sfx}")
        self._h = create(_kp(bk), bk.size, self.num_buckets, _hf_id(hashfun))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.hj3e_table_free(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def probe(self, probe_keys, unique: bool = False, unnest: bool = True,
              out_cap: int | None = None):
        """Probe this table; the returns of ``host_chaining_join`` /
        ``host_nested_join``.  u64 probes of a u32 table raise."""
        pk = _canon_keys(probe_keys)
        if pk.dtype == np.uint64 and self.key_dtype == np.uint32:
            raise ValueError("u64 probe keys against a u32 table would "
                             "truncate; build the table from u64 keys")
        pk = pk.astype(self.key_dtype, copy=False)
        sfx = "64" if self.key_dtype == np.uint64 else ""
        fn = getattr(self._lib, f"hj3e_{self.kind}_probe{sfx}")
        cap = _default_cap(out_cap, pk.size, self.n_rows)
        nested = self.kind == "nested"
        if nested and not unnest:
            cap = 1
        flag = int(unnest) if nested else int(unique)
        op, ob, ctr = _run(
            lambda op, ob, cap, ctr: fn(self._h, _kp(pk), pk.size, flag,
                                        _i32p(op), _i32p(ob), cap,
                                        _i64p(ctr)),
            cap, 3, lambda c: int(c[2] if nested else c[0]), out_cap)
        if nested:
            return op, ob, ctr[0], ctr[1], ctr[2]
        return op, ob, ctr[0], ctr[1]


def host_two_join_probe(tbl_s: HostTable, tbl_t: HostTable, probe_keys,
                        out_cap: int) -> dict:
    """exp-4's probe strand on the host engine: Ndu (nested tables,
    deferred unnesting) or Chj (chaining tables, immediate expansion), the
    kind taken from the tables.  Returns the device strands' counter keys
    (``models/exp4.py``) and the (r, s, t) row-id triples."""
    if tbl_s.kind != tbl_t.kind:
        raise ValueError(f"tables of two kinds: {tbl_s.kind}, {tbl_t.kind}")
    lib = tbl_s._lib
    pk = np.ascontiguousarray(probe_keys, np.uint32)
    cap = max(int(out_cap), 1)
    o_r = np.empty(cap, np.int32)
    o_s = np.empty(cap, np.int32)
    o_t = np.empty(cap, np.int32)
    ctr = np.zeros(7, np.int64)
    ndu = tbl_s.kind == "nested"
    fn = lib.hj3e_ndu_probe if ndu else lib.hj3e_chj_probe
    n = fn(tbl_s._h, tbl_t._h, _u32p(pk), pk.size, _i32p(o_r), _i32p(o_s),
           _i32p(o_t), cap, _i64p(ctr))
    top = int(ctr[6] if ndu else ctr[4])
    if n < 0:
        raise ValueError(f"out_cap={cap} too small (c_top={top})")
    out = dict(r_row=o_r[:n], s_row=o_s[:n], t_row=o_t[:n],
               c_probe_RS=int(ctr[0]), c_probe_RS_cmp=int(ctr[1]),
               c_probe_RT=int(ctr[2]), c_probe_RT_cmp=int(ctr[3]),
               c_top=top)
    if ndu:
        out.update(c_unnest_1=int(ctr[4]), c_unnest_2=int(ctr[5]))
    return out
