"""Executable documentation: four hand-checkable mini-plans.

Port of ``hashjoin3d_tpu/models/algebra_example.py``, the mirror of the
reference's ``main_algebra_example.cc:144-454``: two tiny relations L(a, b)
and R(c, d) and four plans that exercise every operator, the selections
included.

Run: ``python3 -m hashjoin3d_tpu_torch.models.algebra_example [--device
cpu]`` (CUDA by default; asking for CUDA on a host without it raises).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .algebra import (AlgDynSelection, AlgHashJoinBuild, AlgHashJoinProbe,
                      AlgNestJoinBuild, AlgNestJoinProbe, AlgScan,
                      AlgSelection, AlgTop, AlgUnnestHt, GlobStat0, Relation,
                      print_strand)


def relations(device="cuda"):
    L = Relation(device, a=np.array([1, 2, 3, 4], np.uint32),
                 b=np.array([11, 21, 31, 41], np.int32))
    R = Relation(device, c=np.array([1, 1, 1, 2, 2, 3], np.uint32),
                 d=np.array([-1, -2, -3, -1, -2, -1], np.int32))
    return L, R


def test0(out=sys.stdout, device="cuda"):
    """scan -> dyn-selection(b < 40) -> top
    (main_algebra_example.cc:147-185)."""
    out.write("### algebra_test0 ###\n")
    L, _ = relations(device)
    gs = GlobStat0()
    top = AlgTop(out, True, lambda r, o: o.write(f"({r['a']},{r['b']})"))
    sel = AlgDynSelection(top, lambda cols: cols["b"] < 40)
    scan = AlgScan(sel, L)
    scan.run(gs)
    out.write(f"count Top:  {top.count()}\n")
    out.write(f"count Sel:  {sel.count()}\n")
    out.write(f"count Scan: {scan.count()}\n")
    return scan, sel, top


def test1(out=sys.stdout, device="cuda"):
    """3D join emitting nested tuples (main_algebra_example.cc:188-262)."""
    out.write("### algebra_test1 ###\n")
    L, R = relations(device)
    gs = GlobStat0()
    build = AlgNestJoinBuild("c", 5)
    scan_r = AlgScan(build, R)
    top = AlgTop(out, False)
    probe = AlgNestJoinProbe(top, build, "a")
    sel = AlgSelection(probe, lambda cols: cols["b"] < 40)
    scan_l = AlgScan(sel, L)
    scan_r.run(gs)
    scan_l.run(gs)
    out.write(f"Build Strand:\n  count Build: {build.count()}\n"
              f"  count Scan:  {scan_r.count()}\n"
              f"Probe Strand:\n  count Top:   {top.count()}\n"
              f"  count Probe: {probe.count()}\n"
              f"  count Sel:   {sel.count()}\n"
              f"  count Scan:  {scan_l.count()}\n")
    return dict(build=build, scan_r=scan_r, top=top, probe=probe, sel=sel,
                scan_l=scan_l)


def test2(out=sys.stdout, device="cuda"):
    """3D join + unnest (main_algebra_example.cc:265-347)."""
    out.write("### algebra_test2 ###\n")
    L, R = relations(device)
    gs = GlobStat0()
    build = AlgNestJoinBuild("c", 5)
    scan_r = AlgScan(build, R)
    top = AlgTop(out, True, lambda r, o: o.write(
        f"({r['a']},{r['b']},{r['r.c']},{r['r.d']})"))
    unn = AlgUnnestHt(top)
    probe = AlgNestJoinProbe(unn, build, "a")
    sel = AlgSelection(probe, lambda cols: cols["b"] < 40)
    scan_l = AlgScan(sel, L)
    scan_r.run(gs)
    out.write("Output tuples\n")
    scan_l.run(gs)
    out.write("Build Strand:\n")
    print_strand(scan_r, 1, out)
    out.write("Probe Strand:\n")
    print_strand(scan_l, 1, out)
    return dict(build=build, scan_r=scan_r, top=top, unnest=unn, probe=probe,
                sel=sel, scan_l=scan_l)


def test3(out=sys.stdout, device="cuda"):
    """Conventional chaining hash join (main_algebra_example.cc:352-435)."""
    out.write("### algebra_test3 ###\n")
    L, R = relations(device)
    gs = GlobStat0()
    build = AlgHashJoinBuild("c", 5)
    scan_r = AlgScan(build, R)
    top = AlgTop(out, True, lambda r, o: o.write(
        f"({r['l.a']},{r['l.b']},{r['r.c']},{r['r.d']})"))
    probe = AlgHashJoinProbe(top, build, "a")
    sel = AlgSelection(probe, lambda cols: cols["b"] < 40)
    scan_l = AlgScan(sel, L)
    scan_r.run(gs)
    out.write("Output tuples\n")
    scan_l.run(gs)
    out.write("Build Strand:\n")
    print_strand(scan_r, 1, out)
    out.write("Probe Strand:\n")
    print_strand(scan_l, 1, out)
    return dict(build=build, scan_r=scan_r, top=top, probe=probe, sel=sel,
                scan_l=scan_l)


TESTS = (test0, test1, test2, test3)


def main(argv=None, out=sys.stdout) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    for t in TESTS:
        t(out, args.device)
        out.write("- " * 20 + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
