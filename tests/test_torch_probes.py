"""The micro-kernels P1-P9 and the measurement tools of the port, on the CPU.

Each probe wrapper on CPU tensors runs its plain PyTorch version; here it is
held, over the whole output, to the numpy semantics that the TPU probe's
check pins in ``tools/mosaic_probe.py`` (the Pallas probes are closures
there and cannot be called on their own).  The roofline and csrprof row
functions and the probe runner's cases are rehearsed at small sizes with
``device="cpu"``: paths, shapes and results, no times.  Every tool entry
point raises without a CUDA GPU.  The CUDA kernels themselves need the
card: ``chip_smoke.py`` phase 5 holds each against these plain versions.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hashjoin3d_tpu_torch.ops import probes
from hashjoin3d_tpu_torch.tools import csrprof, mosaic_probe, roofline

REPO = Path(__file__).resolve().parents[1]
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def rows_of(rng, rows, lo=I32_MIN, hi=I32_MAX):
    return rng.integers(lo, hi, (rows, 128)).astype(np.int32)


@pytest.mark.parametrize("shift", [5, 0, -3, 130])
def test_roll_is_np_roll(shift):
    x = rows_of(np.random.default_rng(20), 64)
    got = probes.roll(t(x), shift).numpy()
    assert np.array_equal(got, np.roll(x, shift, axis=1))


def test_rotate_rolls_each_row_left_by_its_shift():
    rng = np.random.default_rng(21)
    x = rows_of(rng, 96)
    shifts = rng.integers(-300, 300, 96).astype(np.int32)
    shifts[:3] = [0, 127, 128]
    got = probes.rotate(t(x), t(shifts)).numpy()
    want = np.stack([np.roll(x[r], -int(shifts[r])) for r in range(96)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("axis,block_rows", [(1, 512), (0, 512), (0, 8)])
def test_cumsum_lanes_and_row_blocks_wrap_in_int32(axis, block_rows):
    x = rows_of(np.random.default_rng(22), 1024)
    got = probes.cumsum(t(x), axis, block_rows).numpy()
    if axis == 1:
        want = np.cumsum(x.astype(np.int64), axis=1)
    else:
        want = np.cumsum(x.astype(np.int64).reshape(-1, block_rows, 128),
                         axis=1).reshape(x.shape)
    assert np.array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("matrix", ["reversal", "permutation", "zero_one"])
def test_onehot_matmul_is_the_exact_product(matrix):
    rng = np.random.default_rng(23)
    x = rows_of(rng, 64, 0, 1 << 24)
    x[0, :] = (1 << 24) - 1
    if matrix == "reversal":     # the TPU probe's matrix
        p = np.eye(128, dtype=np.int32)[::-1]
    elif matrix == "permutation":
        p = np.eye(128, dtype=np.int32)[rng.permutation(128)]
    else:                        # several ones per column: sums of bytes
        p = (rng.random((128, 128)) < 0.05).astype(np.int32)
    got = probes.onehot_matmul(t(x), t(p)).numpy()
    want = (x.astype(np.int64) @ p.astype(np.int64)).astype(np.int32)
    assert np.array_equal(got, want)
    if matrix == "reversal":
        assert np.array_equal(got, x[:, ::-1])


@pytest.mark.parametrize("C", [1024, 4096,
                               128, 8192])  # the smallest and largest C
def test_permute_applies_one_permutation_per_block(C):
    rng = np.random.default_rng(24)
    x = rows_of(rng, 8192 // 128 * 4)
    p = rng.permutation(C).astype(np.int32)
    got = probes.permute(t(x), t(p)).numpy()
    want = x.reshape(-1, C)[:, p].reshape(x.shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("off", [8, 0, 24])
def test_masked_store_writes_the_block_and_zeros(off):
    x = np.arange(1 << 14, dtype=np.int32).reshape(-1, 128)
    got = probes.masked_store(t(x), off).numpy()
    want = np.zeros((32, 128), np.int32)
    want[off:off + 8, :64] = x[0:8, :64]
    assert np.array_equal(got, want)
    if off == 8:                 # the TPU probe's check
        assert np.array_equal(got[8:16, :64], x[0:8, :64])


@pytest.mark.parametrize("B", [1024, 8192, 65536,
                               128, 384, 12288])  # any multiple of 128
def test_block_copy_in_reversed_block_order_is_a_copy(B):
    n = 1 << 17 if (1 << 17) % B == 0 else 12 * B
    src = np.random.default_rng(25).integers(0, 1 << 30, n)
    got = probes.block_copy(t(src), B).numpy()
    assert np.array_equal(got, src)


@pytest.mark.parametrize("B", [0, 64, 1000, 3 << 15])
def test_block_copy_takes_multiples_of_128_dividing_the_size(B):
    with pytest.raises(ValueError, match="multiple of 128"):
        probes.block_copy(t(np.zeros(1 << 17)), B)


@pytest.mark.parametrize("off,nrows", [(3, 8), (0, 1), (7, 64),
                                       (120, 8),  # the last 8 of 128 rows
                                       (5, 13)])
def test_row_copy_from_an_unaligned_row_offset(off, nrows):
    src = np.arange(1 << 14, dtype=np.int32).reshape(-1, 128)
    got = probes.row_copy(t(src), off, nrows).numpy()
    assert np.array_equal(got, src[off:off + nrows])


def test_digit_histogram_counts_each_row_into_lanes_0_to_15():
    rng = np.random.default_rng(26)
    x = rng.integers(0, 16, (64, 128)).astype(np.int32)
    x[0, :] = 7
    x[1, :5] = [16, -1, 255, 2**31 - 1, I32_MIN]  # not counted
    got = probes.digit_histogram(t(x)).numpy()
    want = np.zeros((64, 128), np.int32)
    for r in range(64):
        d = x[r][(x[r] >= 0) & (x[r] < 16)]
        want[r, :16] = np.bincount(d, minlength=16)
    assert np.array_equal(got, want)


def test_probe_wrappers_check_their_shapes():
    x = torch.zeros((16, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        probes.onehot_matmul(x[:8], torch.zeros((128, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="off"):
        probes.masked_store(x, 25)
    with pytest.raises(ValueError, match="block_rows"):
        probes.cumsum(x, 0, 12)
    with pytest.raises(ValueError, match="C = 100"):
        probes.permute(x, torch.zeros(100, dtype=torch.int32))


def test_probe_runner_cases_on_the_cpu():
    """Every probe P1-P9 has a case; each case's result (on the CPU, its
    plain version) equals its library call, an independent PyTorch call of
    the same function, where it has one (the tests above hold the rest to
    numpy), and the byte count is positive."""
    cases = mosaic_probe.cases("cpu", shrink=8)
    assert {c.probe for c in cases} == set(mosaic_probe.PROBES)
    assert sum(c.library is not None for c in cases) >= 6
    for c in cases:
        got = c.run()
        assert got.dtype == torch.int32, c.label
        assert roofline.nbytes(*c.inputs, got) > 0
        if c.library is not None:
            lib = c.library()
            assert torch.equal(got, lib.reshape(got.shape).to(got.dtype)), \
                c.label


def test_roofline_rows_rehearsed_on_the_cpu():
    d = roofline.inputs("cpu", 12, 12)
    rows = roofline.table_rows(d)
    names = [r.name for r in rows]
    assert any("K2b" in n for n in names) and any("K2 W" in n for n in names)
    assert any(r.fn is None for r in rows)    # the windows the table lacks
    for r in rows + roofline.kernel_rows(d):
        if r.fn is None:
            continue
        out = r.fn()
        assert r.check is None or r.check(out), r.name
        assert roofline.nbytes(*r.inputs, *roofline._outputs(out)) > 0
        if r.library is not None:
            r.library()
    kernels = [r.name.split()[0] for r in roofline.kernel_rows(d)]
    assert kernels == ["K1", "K2", "K2b", "K3", "K4"]


def test_csrprof_stages_rehearsed_on_the_cpu():
    st = csrprof.stages("cpu", 12, 8)
    outs = {}
    for s in st:
        outs[s.name] = s.fn()
        assert s.check is None or s.check(outs[s.name]), s.name
    full = outs[st[0].name]
    hit, _, _ = next(v for k, v in outs.items() if k.startswith("3 decode"))
    assert int(full["c_htProbe"]) == int(hit.sum()) == 1 << 12
    assert sum(s.top for s in st) == 6


@pytest.mark.parametrize("tool", [roofline, csrprof, mosaic_probe])
def test_tools_raise_without_a_gpu(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        tool.main([])


def test_tools_import_no_jax():
    code = ("import sys, hashjoin3d_tpu_torch.tools.roofline, "
            "hashjoin3d_tpu_torch.tools.csrprof, "
            "hashjoin3d_tpu_torch.tools.mosaic_probe; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'hashjoin3d_tpu.'))]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
