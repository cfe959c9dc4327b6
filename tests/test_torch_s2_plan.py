"""The 2-byte bfloat16 kernels' launch rules, plans only (no graph, no
launch, no card): K1's 2-byte body (``csrc/stencil_conv.cuh``,
``stencil_conv_s2_kernel``) and K2's and K3's (``csrc/stencil_bwd.cuh``,
``stencil_bwd_s2_kernel``).

Each runs the halo windows of several batch indices of one channel group
in one lap (window sets).  How many a lap takes, whether the band mode's
next windows have a landing zone and the shared bytes those cost are one
rule a kernel, ``csrc/stencil_conv_s2.h`` and ``csrc/stencil_bwd_s2.h``,
which the C entry points and the kernels apply.  They include no CUDA
header, so these tests compile them with the host's C++ compiler and check
what they give at every shape where the 2-byte plan
(``ops/fused_stencil.py::_k1_plan`` or ``_bwd_plan`` with ``es=2``) stages
2 bytes: their bytes at one set are that plan's.
"""

import os
import subprocess

import pytest

from deepsphere_tpu_torch.ops import fused_stencil as tfs

_H100_SMS = 132
_HEADER_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "deepsphere_tpu_torch", "csrc")

# reads "T h r nplanes K G FC GB B io smem_max" lines; prints the window
# sets, the most the radius and registers allow, whether the launch has the
# landing zone, the bytes of the sets at 1, ns and 2 ns sets, the zone's at
# ns, then each chunk "first:count" of every block of GB batch indices, as
# the kernel runs them
_DRIVER = r"""
#include <cstdio>
#include "stencil_conv_s2.h"
using namespace ds_k1;
int main() {
  int T, h, r, np, K, G, FC, GB, B, io;
  long long smax;
  while (std::scanf("%d %d %d %d %d %d %d %d %d %d %lld", &T, &h, &r, &np,
                    &K, &G, &FC, &GB, &B, &io, &smax) == 11) {
    const int ns = s2_sets(T, h, r, np, K, G, FC, GB, (size_t)smax);
    const int cap = s2_sets_max(r, (T == 32 && r <= 2) ? 4 : 1, FC, G);
    const int land =
        ns > 0 ? s2_land(T, h, r, np, K, G, FC, ns, io, (size_t)smax) : 0;
    std::printf("%d %d %d %zu %zu %zu %zu", ns, cap, land,
                s2_smem(T, h, r, np, K, G, FC, 1),
                s2_smem(T, h, r, np, K, G, FC, ns),
                s2_smem(T, h, r, np, K, G, FC, 2 * ns), s2_zone(T, h, G, ns));
    for (int b0 = 0; ns > 0 && b0 < B; b0 += GB) {
      const int nb = B - b0 < GB ? B - b0 : GB;
      const int nsb = s2_block_sets(ns, nb);
      for (int c = 0; c < s2_chunks(nb, nsb); ++c)
        std::printf(" %d:%d", b0 + c * nsb, s2_chunk_sets(nb, nsb, c));
    }
    std::printf("\n");
  }
  return 0;
}
"""

# (label, n, h, r, K): where the bfloat16 K1's 2-byte plan stages 2 bytes
# (its float32 bytes do not fit): phase 15's radius-3 conv and the deep
# stencils of tests/test_torch_kernels.py's _BF16_PLANS, radius 1 at
# h >= 13 with G = 4, and nside 16 (few tiles, so a block takes several
# batch indices)
_BASES = [
    ("radius 1, h=13", 64, 13, 1, 14),
    ("radius 1, h=16", 32, 16, 1, 17),
    ("radius 2, h=8", 256, 8, 2, 5),
    ("radius 3, h=12", 256, 12, 3, 5),
    ("radius 3, h=12, nside 16", 16, 12, 3, 5),
    ("radius 4, h=16", 256, 16, 4, 5),
    ("radius 4, h=16, nside 16", 16, 16, 4, 5),
]


def _cases():
    """Every (base, B, Fin, Fout) of the sweep whose 2-byte plan takes the
    2-byte body."""
    out = []
    for label, n, h, r, K in _BASES:
        nplanes = (2 * r + 1) ** 2
        for B in (1, 5, 16, 67):
            for Fin, Fout in ((4, 4), (2, 3), (8, 16)):
                p = tfs._k1_plan(n, h, r, nplanes, K, B, 12, Fin, Fout,
                                 _H100_SMS, 2)
                if p is not None and tfs._k1_bf16_staging(
                        p, h, r, nplanes, K) == 2:
                    out.append((f"{label}, B={B}, {Fin}->{Fout}", n, h, r,
                                K, B, Fin, Fout))
    return out


_CASES = _cases()


@pytest.fixture(scope="module")
def s2_rule(tmp_path_factory):
    """The header's rule, compiled: shape -> its printed fields."""
    d = tmp_path_factory.mktemp("s2_rule")
    src, exe = d / "driver.cc", d / "driver"
    src.write_text(_DRIVER)
    subprocess.run(["c++", "-std=c++17", "-O1", "-I", _HEADER_DIR, "-o",
                    str(exe), str(src)], check=True, capture_output=True,
                   timeout=120)

    def rule(T, h, r, nplanes, K, G, FC, GB, B, io):
        line = (f"{T} {h} {r} {nplanes} {K} {G} {FC} {GB} {B} {int(io)} "
                f"{tfs._SMEM_MAX}\n")
        res = subprocess.run([str(exe)], input=line, capture_output=True,
                             text=True, check=True, timeout=60)
        ns, cap, land, one, at, twice, zone, *chunks = res.stdout.split()
        return dict(ns=int(ns), cap=int(cap), land=bool(int(land)),
                    one=int(one), at=int(at), twice=int(twice),
                    zone=int(zone), chunks=[tuple(map(int, c.split(":")))
                                            for c in chunks])
    return rule


def test_the_sweep_reaches_every_radius(s2_rule):
    """The sweep holds 2-byte shapes at every radius, and phase 15's
    radius-3 conv takes four window sets a lap, and in the band mode its
    landing zone."""
    assert {c[3] for c in _CASES} == {1, 2, 3, 4}
    p = tfs._k1_plan(256, 12, 3, 49, 5, 4, 12, 4, 4, _H100_SMS, 2)
    band, io = (s2_rule(p.T, 12, 3, 49, 5, p.G, p.FC, p.GB, 4, io)
                for io in (False, True))
    assert band["ns"] == io["ns"] == 4
    assert band["land"] and not io["land"]


@pytest.mark.parametrize("label,n,h,r,K,B,Fin,Fout", _CASES,
                         ids=[c[0] for c in _CASES])
def test_k1_s2_window_sets(s2_rule, label, n, h, r, K, B, Fin, Fout):
    """At every 2-byte shape: one, two or four window sets a lap (the
    kernel's compiled counts), one at radius <= 2, no more than the
    registers and the block's batch indices allow, the most of those that
    fit; the body's bytes fit ``_SMEM_MAX`` and are the 2-byte plan's at
    one set; the landing zone in the band mode exactly where it fits beside
    the sets, never in the I/O mode; and the blocks' chunks of sets cover
    every batch index once where B is no multiple of the sets (or of the
    plan's GB)."""
    nplanes = (2 * r + 1) ** 2
    p = tfs._k1_plan(n, h, r, nplanes, K, B, 12, Fin, Fout, _H100_SMS, 2)
    band, io = (s2_rule(p.T, h, r, nplanes, K, p.G, p.FC, p.GB, B, io)
                for io in (False, True))
    ns, cap = band["ns"], min(band["cap"], p.GB)
    assert ns in (1, 2, 4) and ns <= cap
    assert band["cap"] in (1, 2, 4) and (r > 2 or band["cap"] == 1)
    assert band["one"] == p.smem
    assert band["at"] <= tfs._SMEM_MAX
    assert 2 * ns > cap or band["twice"] > tfs._SMEM_MAX
    assert band["land"] == (band["at"] + band["zone"] <= tfs._SMEM_MAX)
    assert not io["land"]
    assert {k: v for k, v in io.items() if k != "land"} == {
        k: v for k, v in band.items() if k != "land"}
    covered = [b for first, count in band["chunks"]
               for b in range(first, first + count)]
    assert sorted(covered) == list(range(B))
    assert all(1 <= count <= ns for _, count in band["chunks"])


# reads "T h r nplanes K G FC Crec dx GB B io smem_max" lines; prints the
# window sets, the most the radius and registers allow, whether the launch
# has the landing zone, the bytes at 1, ns and 2 ns sets, the (float32)
# zone's at ns, the blocks an SM holds at one set, at ns sets (with the zone where
# the launch has it: the launch bounds of the instantiation it takes) and at
# 2 ns sets, then each chunk "first:count" of every block of GB batch
# indices, in the order the kernel runs them
_BWD_MAIN = r"""
#include <cstdio>
#include "stencil_bwd_s2.h"
using namespace ds_bwd;
int main() {
  int T, h, r, np, K, G, FC, Crec, dx, GB, B, io;
  long long smax;
  while (std::scanf("%d %d %d %d %d %d %d %d %d %d %d %d %lld", &T, &h, &r,
                    &np, &K, &G, &FC, &Crec, &dx, &GB, &B, &io, &smax) == 13) {
    const int PP = (T == 32 && r <= 2) ? 4 : 1;
    const int ns = s2_sets(T, h, r, np, K, G, FC, Crec, dx, GB, (size_t)smax);
    const int m = ns > 0 ? ns : 1;
    const int land =
        ns > 0 ? s2_land(T, h, r, np, K, G, FC, Crec, dx, ns, io,
                         (size_t)smax) : 0;
    const size_t one = s2_smem(T, h, r, np, K, G, FC, Crec, dx, 1);
    const size_t at = s2_smem(T, h, r, np, K, G, FC, Crec, dx, m);
    const size_t twice = s2_smem(T, h, r, np, K, G, FC, Crec, dx, 2 * m);
    const size_t zone = ds_k1::s2_zone(T, h, G, m);
    std::printf("%d %d %d %zu %zu %zu %zu %d %d %d", ns,
                s2_sets_max(r, PP, FC, G, dx), land, one, at, twice, zone,
                s2_blocks(dx, PP, FC, 1, one),
                s2_blocks(dx, PP, FC, m, at + (land ? zone : 0)),
                s2_blocks(dx, PP, FC, 2 * m, twice));
    for (int b0 = 0; ns > 0 && b0 < B; b0 += GB) {
      const int nb = B - b0 < GB ? B - b0 : GB;
      const int nsb = ds_k1::s2_block_sets(ns, nb);
      for (int c = 0; c < ds_k1::s2_chunks(nb, nsb); ++c)
        std::printf(" %d:%d", b0 + c * nsb,
                    ds_k1::s2_chunk_sets(nb, nsb, c));
    }
    std::printf("\n");
  }
  return 0;
}
"""

# (label, n, h, r, K): where K2's or K3's 2-byte plan stages 2 bytes (the
# float32 bytes do not fit it, or cost a block an SM): K1's bases and
# quick_start's conv 1 (K=10, h=9: K2 at 1 -> 8, whose float32 bytes hold
# one block an SM where 2 bytes hold two)
_BWD_BASES = _BASES + [("quick_start conv 1", 64, 9, 1, 10)]


def _bwd_cases():
    """Every (base, B, Fin, Fout, role) of the sweep whose 2-byte plan takes
    the 2-byte kernel."""
    out = []
    for label, n, h, r, K in _BWD_BASES:
        nplanes = (2 * r + 1) ** 2
        for B in (1, 5, 16, 67):
            for Fin, Fout in ((4, 4), (2, 3), (8, 16), (1, 8)):
                for role, Crec, Cch in (("K2", Fout, Fin), ("K3", Fin, Fout)):
                    dx = role == "K2"
                    p = tfs._bwd_plan(n, h, r, nplanes, K, B, 12, Crec, Cch,
                                      dx, _H100_SMS, 2)
                    if p is not None and tfs._bwd_bf16_staging(
                            p, h, r, nplanes, K, Crec, dx) == 2:
                        out.append((f"{role} {label}, B={B}, {Fin}->{Fout}",
                                    n, h, r, K, B, Crec, Cch, dx))
    return out


_BWD_CASES = _bwd_cases()


@pytest.fixture(scope="module")
def bwd_rule(tmp_path_factory):
    """The backward's header rule, compiled: shapes -> their printed
    fields (one process for every line)."""
    d = tmp_path_factory.mktemp("bwd_s2_rule")
    src, exe = d / "rule.cc", d / "rule"
    src.write_text(_BWD_MAIN)
    subprocess.run(["c++", "-std=c++17", "-O1", "-I", _HEADER_DIR, "-o",
                    str(exe), str(src)], check=True, capture_output=True,
                   timeout=120)

    def rule(lines):
        text = "".join(
            f"{T} {h} {r} {nplanes} {K} {G} {FC} {Crec} {int(dx)} {GB} {B} "
            f"{int(io)} {tfs._SMEM_MAX}\n"
            for T, h, r, nplanes, K, G, FC, Crec, dx, GB, B, io in lines)
        res = subprocess.run([str(exe)], input=text, capture_output=True,
                             text=True, check=True, timeout=60)
        out = []
        for ln in res.stdout.splitlines():
            ns, cap, land, one, at, twice, zone, b1, bns, b2, *chunks = (
                ln.split())
            out.append(dict(
                ns=int(ns), cap=int(cap), land=bool(int(land)), one=int(one),
                at=int(at), twice=int(twice), zone=int(zone),
                blocks_one=int(b1), blocks_at=int(bns), blocks_twice=int(b2),
                chunks=[tuple(map(int, c.split(":"))) for c in chunks]))
        return out
    return rule


@pytest.fixture(scope="module")
def bwd_sweep(bwd_rule):
    """The rule at every case of the sweep, in both modes: label ->
    (plan, band fields, I/O fields)."""
    lines, plans = [], []
    for label, n, h, r, K, B, Crec, Cch, dx in _BWD_CASES:
        nplanes = (2 * r + 1) ** 2
        p = tfs._bwd_plan(n, h, r, nplanes, K, B, 12, Crec, Cch, dx,
                          _H100_SMS, 2)
        plans.append(p)
        for io in (False, True):
            lines.append((p.T, h, r, nplanes, K, p.G, p.FC, Crec, dx, p.GB, B,
                          io))
    got = bwd_rule(lines)
    return {c[0]: (p, got[2 * i], got[2 * i + 1])
            for i, (c, p) in enumerate(zip(_BWD_CASES, plans))}


def test_bwd_sweep_reaches_every_radius(bwd_sweep):
    """The backward's sweep holds 2-byte shapes of both roles at every
    radius, K2 at quick_start's conv 1 among them, and phase 15(d)'s
    radius-3 conv (nside 256, K=5, 4 -> 4, batch 4) takes four window sets
    a lap in both roles, in the band mode with its landing zone (the I/O
    mode has none)."""
    assert {(c[3], c[8]) for c in _BWD_CASES} == {
        (r, dx) for r in (1, 2, 3, 4) for dx in (True, False)}
    assert "K2 quick_start conv 1, B=16, 1->8" in bwd_sweep
    for role in ("K2", "K3"):
        _, band, io = bwd_sweep[f"{role} radius 3, h=12, B=5, 4->4"]
        assert band["ns"] == io["ns"] == 4
        assert band["land"] and not io["land"]
        assert io["zone"] == band["zone"]


@pytest.mark.parametrize("label,n,h,r,K,B,Crec,Cch,dx", _BWD_CASES,
                         ids=[c[0] for c in _BWD_CASES])
def test_bwd_s2_window_sets(bwd_sweep, label, n, h, r, K, B, Crec, Cch, dx):
    """At every 2-byte shape of K2 and K3: one, two or four window sets a
    lap (the kernel's compiled counts), one at radius <= 2, no more than
    the registers (K2: dx sums and fold values a set; K3: fold values) and
    the block's batch indices allow, the most of those that fit and keep
    the blocks an SM holds at one set; the bytes at one set and the blocks
    an SM holds there are the 2-byte plan's (``_bwd_smem``,
    ``_bwd_blocks``), which the sets and the zone keep; the landing zone
    in the band mode exactly where it fits and keeps those blocks, never in
    the I/O mode; and the chunks of sets take every batch index once, in
    order."""
    p, band, io = bwd_sweep[label]
    ns, cap = band["ns"], min(band["cap"], p.GB)
    pp = 4 if p.T == 32 and r <= 2 else 1
    assert ns in (1, 2, 4) and ns <= cap
    assert band["cap"] in (1, 2, 4) and (r > 2 or band["cap"] == 1)
    assert band["cap"] <= max(1, 32 // ((2 if dx else 1) * pp * p.FC))
    assert band["one"] == p.smem
    assert band["blocks_one"] == tfs._bwd_blocks(p, r, dx, p.smem) >= 1
    assert band["at"] <= tfs._SMEM_MAX
    assert (2 * ns > cap or band["twice"] > tfs._SMEM_MAX
            or band["blocks_twice"] < band["blocks_one"])
    for mode in (band, io):
        assert mode["blocks_at"] == band["blocks_one"]
    assert not io["land"]
    assert band["land"] == (
        band["at"] + band["zone"] <= tfs._SMEM_MAX
        and tfs._SMEM_SM // (band["at"] + band["zone"] + 1024)
        >= band["blocks_one"])
    mode_keys = ("land", "blocks_at")
    assert {k: v for k, v in io.items() if k not in mode_keys} == {
        k: v for k, v in band.items() if k not in mode_keys}
    covered = [b for first, count in band["chunks"]
               for b in range(first, first + count)]
    assert covered == list(range(B))
    assert all(1 <= count <= ns for _, count in band["chunks"])
