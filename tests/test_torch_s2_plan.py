"""K1's 2-byte bfloat16 body (``csrc/stencil_conv.cuh``,
``stencil_conv_s2_kernel``): its launch rule, plans only (no graph, no
launch, no card).

The body runs the halo windows of several batch indices of one channel
group in one lap (window sets).  How many a lap takes, whether the band
mode's next windows have a landing zone and the shared bytes those cost
are one rule, ``csrc/stencil_conv_s2.h``, which the C entry point and the
kernel apply.  It includes no CUDA header, so these tests compile it with
the host's C++ compiler and check what it gives at every shape where the
2-byte plan (``ops/fused_stencil.py::_k1_plan`` with ``es=2``) stages 2
bytes: its bytes at one set are that plan's.
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
