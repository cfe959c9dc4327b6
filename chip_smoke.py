#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

Run from the root of a checkout on a machine with an H100 (sm_90):

    python3 chip_smoke.py

Phases, one result line each (with the elapsed seconds):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: one ``nvcc`` per ``deepsphere_tpu_torch/csrc/*.cu``, all at once
   (ptxas register / spill lines are printed), while a side process builds
   the headline's nside-1024 graph and stencil into ``.bench_cache/``
   (phase 3 loads them);
3. kernels against their plain PyTorch versions on identical CUDA inputs
   (garbage in every halo lane), at the shapes of the quick_start convs 1-3
   (batch 16, K=10, h=9) and of the headline conv (nside 1024, batch 4,
   Fin=Fout=4, K=5): the strip gather (K4) exactly; the raw forward conv
   (K1) and the corrected conv to 2e-5 of the plain max; the raw backward
   kernels K2 (dx to 2e-5, dW to 1e-4) and K3 (dW to 1e-4: each entry sums
   a whole map of products, in another order), each dW bitwise-equal across
   two calls; times beside the plain times, the bound and, for K4, the one
   PyTorch call that computes the same gather (``index_select``).  The
   kernels and ``index_select`` are timed by CUDA-graph replay (device
   time: an eager call of a small kernel costs the host more than the
   card), the plain versions with CUDA events around eager calls;
4. serving: the quick_start classifier at nside 64, full width, random
   weights from a seed, answers 4 requests of 16 maps through
   ``model.predict`` on the card; each of the three cface convs must launch
   K4 and K1 once per forward (the fused route: the per-step route's count
   stays 0), and the logits must match the same model on the CPU (a float64
   copy planned in NEST, one request) to max rel 1e-4;
5. training: the same classifier (weights from another seed), batch 16:
   one ``train_on_batch`` on each backward route (``config.fused_dw`` True:
   K2; False: K1 on dy + K3), with the launches of each step counted; the
   loss (1e-5), every gradient (1e-3) and the BN statistics (1e-5) held to
   one float64 step of a CPU copy planned in NEST (its convs per step;
   batch norm makes the conv kernels' gradients a cancellation that a
   float32 CPU step resolves only to ~2e-3, so the card is not held to
   one); ``fit`` for 2 epochs
   over 64 maps (every loss finite); ms per synchronized step on both
   routes (median of 10, the routes alternating, after warm-up); a
   ``torch.profiler`` window over 3 steps (device ops, device-busy share,
   the kernels that take the most time);
6. the headline conv (nside 1024, K=5 Chebyshev, Fin=Fout=4, batch 4) on
   the kernels against the plain per-step path, both on the card: forward,
   then forward + backward with a fixed random cotangent on both routes
   (dx to 2e-5, dW to 1e-4);
7. sharded, on a 1 x 1 ``("data", "pixel")`` mesh of one NCCL rank: (a) the
   edge-band cut (K5) against its plain version, exactly, at the quick_start
   convs' shapes on 12 and on 3 faces and at the headline, with its time
   and the ``index_select`` of the same map taken in turns (K5,
   index_select, index_select, K5, twice; the medians and the spread of
   their ratio), and its bound: each distinct interior source element read
   once and the output written once; (b) the shard data flow:
   K5 on 4 face slices, the buffers concatenated as the all-gather returns
   them, every shard's strips from them, exactly the unsharded K4 strips'
   slices and the plain band strips; (c) the face-sharded headline conv,
   forward and forward + backward, against the unsharded conv on the K1+K3
   route (y, dx 2e-5; dW 1e-4); (d) the quick_start classifier under the
   mesh (``shard_cfg``, ``Trainer(data_sharding=...)``), 3 steps through
   ``data_iterator`` with their launches counted (3 K5 per forward), the
   first from phase 5's weights and batch held to the unsharded K1+K3 step
   on the card and to phase 5's float64 CPU step (loss 1e-5, gradients
   1e-3, BN 1e-5), and ms per step of both;
8. the per-step cface route: a classifier on the k=60 grid graph (one
   Chebyshev K=5 conv, radius 4 at h=16, a shape K1-K3 refuse and where
   the JAX package runs no kernel either; nside 32,
   batch 4, 1 -> 8 channels, a pool and Dense(4)), built on the card:
   ``cface_route`` must name the per-step route, a forward and one train
   step must count it once each and launch no kernel, and the logits
   (1e-4), the loss (1e-5) and every gradient (1e-4) must match the same
   model on the CPU (the fused route's plain versions);
9. the lap chain (one L~ application per launch on the shallow stencil,
   h = radius: K4 strips, then K1 with the term selector kernel; the
   recursion and the contraction between the launches): (a) a k=40 grid
   graph (radius 3) at nside 256, Chebyshev K=5, 4 -> 4, batch 4, NEST
   layout: the route counted once a forward, 4 K1 and 4 K4 launches, y
   against the per-step path on the card (2e-5), forward + backward with a
   fixed cotangent on both routes (dx 2e-5, dW 1e-4; K2 once a lap, or K1
   on dy once a lap and no K3), and device times by graph replay of the
   chain, one lap's K1 and the one-shot conv on the deep stencil (h=12)
   with its K1; (b) ROADMAP fault 3.2 inside a classifier on the k=20 graph
   at nside 64, batch 16 (Chebyshev K=11, h=20, 1 -> 8 -> 16, a pool,
   Dense(4)): ``cface_route`` names the chain for conv 2 in training;
   serving takes the one-shot K1, a training forward and one
   ``train_on_batch`` on each route count the chain and launch K1, K4 and
   K2 or K3; logits (1e-4), loss (1e-5) and every gradient (1e-3) against
   one float64 CPU step;
10. the conv family at full width: (a) the autoencoder of
   ``examples/autoencoder.py`` (nside 64 -> 16 -> 64, Chebyshev K=5 convs
   of 8 and 16 channels, pseudo-convs and their transposes) as one cface
   segment: 4 requests of 8 maps (5 K4 and 5 K1 a forward), two MSE train
   steps with Adam on each route, held to a float64 CPU step as phase 5;
   ms per step, device ops and device-busy share; (b)
   ``examples/advanced_masked.py``'s stack on the full sphere (nside 64,
   batch 16), its residual layer in cface with batch norm and with layer
   norm: a forward (logits 1e-4) and a train step against float64 (loss
   1e-5; gradients 1e-3 of the tree's largest entry and BN statistics 1e-5
   absolute, since its normalised convs make several leaves cancellations
   that float32 resolves only to ~3e-3 of their own max); (c) a Bernstein
   conv with and without the reference quirk: no kernel, against the CPU.
   The float64 references of phases 9-10 are CPU copies planned in the
   NEST layout (per-step convs), the parameters copied;
11. smoothing: (a) ``bench.py``'s smooth stage (nside 1024, sigma 10', the
   stencil method, one map, one channel: m = 5 repetitions of a radius-4
   template, 81 taps), its operator built and cached in a second process
   beside phases 3-10: the layer's forward launches K4 and K1 once a pass
   (one template application a pass; route ``smooth_fused``), the map on
   the kernels within 2e-5 of the plain per-step chain on the same CUDA
   input, a constant map kept to 1e-6, the gradient of sum(w S^m x)
   through the exact transpose backward (no launch) within 1e-5 of the
   plain chain's VJP (the same autograd chain: 0 by construction), and at
   nside 64 (the same sigma / spacing ratio) S^m x and (S^m)^T w within
   1e-5 of m float64 scipy matvecs of the template's ELLPACK and of its
   transpose; device times by graph replay of the chain, the layer and
   one pass's K1 beside their bytes bound (the tap planes, x in, y out, a
   pass) and the plain chain by CUDA events; the whole chain in one pass
   (h = 20) is checked and timed where K1 has a plan for it;
   (b) a polar cap at nside 64, 3 channels of per-channel repetitions,
   both methods: the card against the CPU (1e-5);
12. the reference's every-layer network (``tests/test_networks.py:28-43``)
   at its nside 256, batch 4: pseudo-convs, a pool, Chebyshev, a ViT
   (dense attention over 3,072 tokens at nside 64), monomial, Bernstein,
   the edge-sparse transformer at nside 16, a residual layer, Dense(4);
   4 requests through ``predict`` (K4 and K1 once per cface conv, logits
   1e-4 of a float64 CPU copy planned in NEST), one ``train_on_batch`` on
   each backward route against its float64 step (loss 1e-5, gradients
   1e-3; a key bias's gradient, 0 but for rounding, over the tree's
   largest entry), ms per step with the routes alternating, device ops
   and device-busy share;
13. export and serve: phase 4's quick_start classifier and phase 10(a)'s
   autoencoder, each exported on the card with a polymorphic batch
   (``save_exported``, its bytes reported) and replayed by a fresh
   process (``--replay``) that loads it through ``serve.load_exported``
   with every graph builder patched to raise and answers 16 and 5 maps
   (the autoencoder 8 and 3): the graph's ``stencil_conv`` and ``strips``
   nodes and each request's launches one per cface conv, the logits within
   1e-5 of the live model's ``predict`` on the card, the replayed forward
   timed with CUDA events beside the eager one; (b) the host cost of the
   ops' dispatch in one process: K4 through its op against its CUDA
   implementation called directly, and the quick_start train step with the
   ops against with their implementations called directly, in turns;
14. the TF2 user's path on the reference's kNN graph: (a) the kNN graphs
   of nside 64 at k=8 and k=20 built on the host (``scipy``'s cKDTree and
   a replay of sklearn's tree in the tied rows, ``graph/kdtree.py``;
   sklearn is never imported), with their seconds; (b) quick_start at full
   width on the k=8 kNN graph (``graph_method="knn"``, batch 16), its
   weights loaded from a reference checkpoint's group tree made from
   seeded numpy (``train.import_ref._import_tree``: the walk of
   ``import_keras_h5`` without the file), each conv's route printed (conv
   1 in cface on the kNN deep stencil, h=18, its corner correction
   recomputing rows from the ball; convs 2-4 per step), 4 requests of 16
   maps (one K4 and one K1 a request), all 64 logits against a CPU copy
   loaded from the same tree (1e-4), one ``train_on_batch`` on each
   backward route against a float64 CPU step that takes the card step's
   max-pool and ReLU decisions (loss 1e-5, gradients 1e-3, BN 1e-5; where
   float64's own picks differ is printed), ms per step with the routes
   alternating, and a profiler window of 3 steps written
   by ``utils.profiling.trace`` (every layer's scope and the kernels'
   launches in the trace; the device-busy share); (c) the same model with
   ``remat=True``, one step on each route: loss, gradients and BN
   statistics within 1e-6 of the plain step's on the card, one more
   forward's K4 and K1 a step, the peak memory of both settings and their
   ms per step; (d) one Chebyshev K=10 conv on the k=20 kNN graph (radius
   3), batch 16, 8 -> 16, NEST: the lap chain counted, forward and forward
   + backward with a fixed cotangent on both routes against the per-step
   path on the card (y and dx 2e-5, dW 1e-4); (e) conv 1's filters
   localized on the card against the CPU model's (1e-5);
15. the bfloat16 modes (``config.conv_dtype`` "bfloat16", the band mode,
   and "bfloat16_io"): (a) the bfloat16 instantiations of K1, K2 and K3 in
   each mode at phase 3's four shapes against their plain bfloat16
   versions on identical CUDA inputs (1e-2 of the plain max: both round
   at the same points and sum in other orders), each dW bitwise-repeatable,
   and K4 on the I/O mode's bfloat16 strips exactly; their times beside
   the float32 kernels' (phase 3), the plain versions' and the bound (the
   I/O mode's bytes at 2 bytes an element); (b) the headline conv's
   forward and train step on both routes in each mode against the float32
   conv (3e-2 of its max); (c) quick_start trained three steps in each mode
   (K2, K1+K3, K2: every loss finite, the launches of each step by mode),
   phase 4's model served in each mode (finite logits, their distance from
   the float32 model's printed), and the
   "bfloat16_io" model exported and replayed by a fresh process under its
   mode: logits bitwise equal to the live model's; (d) phase 9(a)'s
   radius-3 conv (nside 256, K=5, h=12), where K1, K2 and K3 hold 2-byte
   shared elements (``_s2``): the raw kernels as in (a), and the conv's
   forward and train step on both routes in each mode against the
   float32 conv.

It then prints the card line, one JSON line with every kernel's launches
(the sum over the main paths, each counted from 0: quick_start training
for K1-K4, the sharded training for K5, phases 9-12, the replays of
phase 13 under ``export``, and phase 14's kNN serving, steps and chain
under ``knn`` and its remat steps under ``remat``, phase 15's under
``bf16_*``, with the paths under ``paths``; the bfloat16 instantiations
are entries of their own, ``*_bf16`` and ``*_bf16_io``), error, times
and bound, and finally
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result line.  It needs one card, never falls back to
the CPU, and imports no JAX.

Five other modes measure only:

    python3 chip_smoke.py --kernel-times ROOT [--s2]
    python3 chip_smoke.py --compare PARENT [OUT.json] [--s2]
    python3 chip_smoke.py --memory [OUT.json]
    python3 chip_smoke.py --sass PARENT [OUT.json]
    python3 chip_smoke.py --ab KERNEL [EDITS.json ...] [--parent DIR] [--s2]

and ``--replay ARTIFACT X.npy OUT_DIR B...`` is phase 13's serving
process.

``--kernel-times`` times K1-K5 and the ``index_select`` of K4's and K5's
maps at the four phase-3 shapes, K1, K2 and K3 in each bfloat16 mode (with
a digest of each output's bits), K1 at the five shapes of its 2-byte
bfloat16 body (``S2_SHAPES``: phase 15(d)'s radius-3 conv, radius 4 at h =
16, radius 2 at h = 8, radius 1 at h = 13, on random arrays) in each mode
with digests, beside the float32 K1 where it has a plan and the bounds,
K2 and K3 at the shapes of their 2-byte kernel (``S2_BWD_SHAPES``: those
five in both roles, K2 at quick_start's conv 1, and radius 3 and 4 at
batch 1, one window set a lap) in each mode with digests and bounds,
phase 15(d)'s radius-3 conv (forward and train step on each route, float32
and each bfloat16 mode, device time and host clock), and the quick_start
train step on both backward routes (as phase 5 does), with the package of
the checkout ROOT (``--s2``: only the 2-byte shapes and the radius-3 conv);
``--compare`` runs it for the checkout PARENT (another commit, e.g.
unpacked with ``git archive``) and this one in turns, parent, this, this,
parent, and also writes the pairs to OUT.json.  ``--memory`` records the
allocator through one train step of phase 14's kNN quick_start on each
backward route, with and without remat, and sums the allocations live at
the step's peak by the code that made them.  ``--sass`` builds the kernel
library of the checkout PARENT and of this one and counts the parent's
kernels whose machine code (``cuobjdump -sass``) this library holds
unchanged.  ``--ab KERNEL`` builds the sources of K1 (``k1``:
``csrc/stencil_conv*.cu``) or of K2 and K3 (``bwd``:
``csrc/stencil_dxdw*.cu``, ``stencil_grad*.cu``) alone, as they are
(their bfloat16 launches in the staging the shape gets, and in the 2-byte
kernels: for K1 by a second build with its C entry's pick forced, for K2
and K3 by the C entries' prec 3 and 4, which name that staging), and with
the header edits of each EDITS.json (a list of [old, new] strings applied
to ``stencil_conv.cuh`` or ``stencil_bwd.cuh``; the variant is named by
the file), checks that each build's bfloat16 outputs (K2's dx and dW, K3's
dW) equal the 2-byte kernels' bit for bit in both modes at twelve shapes
(``AB_BITS``: odd and even h, radius 1-4, both stagings, partial window
sets), and times the float32 kernel and every build's bfloat16 kernel in
each mode at the four phase-3 shapes (K2 and K3 each in its role) and
where the 2-byte kernels run (K1 at ``S2_SHAPES``, K2 and K3 at
``S2_BWD_SHAPES``), in turns, on random inputs; with ``--parent DIR`` the
same kernels' sources of the checkout DIR (another commit, e.g. unpacked
with ``git archive``) are built as they are and checked and timed beside
them (variant ``parent``; for ``bwd`` also its 2-byte kernels forced,
``parent_s2``; ``bwd`` with no EDITS.json takes both checkouts' own
libraries instead, the builds ``--sass`` shares), and ``--s2`` times only
where the 2-byte kernels run; writes ``chiprun_out/ab_KERNEL.json``.
"""

import atexit
import copy
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import scipy.sparse
import torch

TOL = 2e-5  # max|kernel - plain| / max|plain|, float32 sums in another order
DW_TOL = 1e-4  # the same for a dW: each entry sums a whole map of products
GRAD_TOL = 1e-3  # a train step's gradients against float64, of each max
BN_TOL = 1e-5  # its BN statistics against float64
HBM = 3.35e12  # H100 SXM bytes/s
FP32 = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
T0 = time.perf_counter()


def say(phase, msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=20, reps=5):
    """Device milliseconds of ``fn()`` with no host in between: ``iters``
    calls captured in one CUDA graph, each of ``reps`` replays timed with
    CUDA events, the median replay over ``iters``.  For a kernel whose eager
    call costs the host more than the card (a few MB moved), where
    ``cuda_ms`` would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return float(np.median(times))


def device_profile(fn, steps, top=0, host=0):
    """Per call of ``fn(i)`` over ``steps`` calls, from ``torch.profiler``:
    (device ops, device-busy ms, [(name, ops, ms)] of the ``top`` device
    kernels by time, [(name, calls, ms)] of the ``host`` host ops by self
    CPU time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
    # the model's layer scopes (``record_function``) are mirrored onto the
    # device's timeline as ranges around its kernels: not device work
    scopes = {e.name for e in prof.events() if e.is_user_annotation}
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in scopes):
            d = by_name.setdefault(e.name, [0, 0.0])
            d[0] += 1
            d[1] += e.time_range.elapsed_us() / 1e3
    ops = sum(v[0] for v in by_name.values()) / steps
    busy = sum(v[1] for v in by_name.values()) / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    on_host = []
    if host:
        on_host = sorted(((a.key, a.count / steps,
                           a.self_cpu_time_total / 1e3 / steps)
                          for a in prof.key_averages()),
                         key=lambda r: -r[2])[:host]
    return (ops, busy, [(nm, c / steps, t / steps) for nm, (c, t) in ranked],
            on_host)


def rel_err(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / max(scale, 1e-30)


def grads_of(m):
    from deepsphere_tpu_torch.interop import export_jax_variables

    return export_jax_variables(m, grads=True)


def stats_of(m):
    from deepsphere_tpu_torch.interop import export_jax_variables

    return export_jax_variables(m)["batch_stats"]


def tree_errs(got, want, path="", scale=None):
    """{leaf path: max|got - want| / max|want|}, or over ``scale`` instead
    of each leaf's own max where it is given."""
    out = {}
    for k, v in want.items():
        if isinstance(v, dict):
            out.update(tree_errs(got[k], v, f"{path}/{k}", scale))
        else:
            den = np.abs(v).max() if scale is None else scale
            out[f"{path}/{k}"] = float(np.abs(got[k] - v).max()
                                       / max(den, 1e-30))
    return out


def tree_max(tree):
    """The largest magnitude in a tree of arrays."""
    return max(tree_max(v) if isinstance(v, dict) else float(np.abs(v).max())
               for v in tree.values())


def held(errs, tol):
    """Leaves where the card is further from the reference than ``tol``."""
    return {k: e for k, e in errs.items() if not e <= tol}


def counted(fn):
    """Run ``fn`` with every launch and route count at 0; returns (its
    result, the launches, the routes), read after a synchronize."""
    from deepsphere_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_cuda.launch_counts), dict(_cuda.route_counts)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time of the work on the card,
    the larger of its bytes over HBM and its float32 operations over the
    non-tensor-core peak."""
    tb, tf = nbytes / HBM * 1e3, flops / FP32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def tile_work(st, K, C, es=4):
    """Bytes of C channels' halo ring and of the weight planes the
    recursion needs (``es`` bytes an element: 2 for bfloat16 arrays), and
    its operations (taps, Chebyshev combine)."""
    n, h, r = st.nside, st.n_steps, st.radius
    nplanes = len(st.offsets)
    halo = C * 12 * ((n + 2 * h) ** 2 - n * n) * es
    planes = nplanes * 12 * (n + 2 * h - 2 * r) ** 2 * es
    side = [n + 2 * (h - r * k) for k in range(1, K)]
    laps = C * 12 * sum(s * s for s in side) * nplanes * 2
    cheby = C * 12 * sum(s * s for s in side[1:]) * 2
    return halo + planes, laps + cheby


def k1_bound(st, K, B, Fin, Fout, es=4):
    """(ms, by) of one K1 launch: the interior lanes of B*Fin channels in
    and B*Fout out, the halo ring and weight planes (:func:`tile_work`), of
    ``es`` bytes an element, and the (K, Fin, Fout) float32 kernel; the
    recursion's and the contraction's operations."""
    n = st.nside
    tb, tf = tile_work(st, K, B * Fin, es)
    cells = 2 * K * Fin * Fout * B * 12 * n * n
    return bound(es * 12 * n * n * B * (Fin + Fout) + tb + 4 * K * Fin * Fout,
                 tf + cells)


def bwd_bound(st, K, B, Fin, Fout, dx, es=4, mask=False):
    """(ms, by) of one K2 (``dx``) or K3 launch: the interior lanes of
    the recursion input (dy, B*Fout channels, or x, B*Fin) with its halo
    ring and the weight planes (:func:`tile_work`), of the fold operand
    (x, or dy) and of dx, ``es`` bytes an element, the float32 kernel and
    dW, and K2's float32 mask plane and its products where it is given a
    ``mask``; the recursion's operations and the contractions' (K2: dx
    and dW; K3: dW)."""
    M = 12 * st.nside ** 2
    cells = 2 * K * Fin * Fout * B * M
    if dx:
        tb, tf = tile_work(st, K, B * Fout, es)
        masked = (M * 4, B * Fin * M) if mask else (0, 0)
        return bound(es * M * B * Fout + tb + 4 * K * Fin * Fout
                     + es * M * B * Fin + masked[0] + es * M * B * Fin
                     + 4 * K * Fin * Fout, tf + 2 * cells + masked[1])
    tb, tf = tile_work(st, K, B * Fin, es)
    return bound(es * M * B * Fin + tb + es * M * B * Fout
                 + 4 * K * Fin * Fout, tf + cells)


def autoencoder_layers(hp_nn, nside, bottleneck):
    """``examples/autoencoder.py``'s encoder and decoder layers (its
    published widths: Chebyshev K=5 convs of 8 * 2^i channels, pseudo-convs
    down to the bottleneck and transposes back) as one layer list."""
    steps = int(np.log2(nside // bottleneck))
    layers = []
    for i in range(steps):
        layers += [hp_nn.HealpyChebyshev(K=5, Fout=8 * 2**i, activation="relu"),
                   hp_nn.HealpyPseudoConv(p=1, Fout=8 * 2**i)]
    for i in reversed(range(steps)):
        layers += [hp_nn.HealpyPseudoConv_Transpose(p=1, Fout=8 * 2**i),
                   hp_nn.HealpyChebyshev(K=5, Fout=8 * 2**i, activation="relu")]
    layers.append(hp_nn.HealpyChebyshev(K=5, Fout=1))
    return layers


def masked_layers(hp_nn, norm):
    """``examples/advanced_masked.py``'s layer stack, ``norm_type`` in the
    residual layer."""
    return [
        hp_nn.HealpyChebyshev(K=5, Fout=8, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.Healpy_ResidualLayer("CHEBY", {"K": 5}, activation="relu",
                                   use_bn=True, norm_type=norm),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyMonomial(K=3, Fout=16, activation="relu"),
        hp_nn.Flatten(),
        hp_nn.Dense(2),
    ]


def nest_reference(dt, model, nside, layers, **kw):
    """A float64 CPU copy of ``model`` planned in the NEST layout (its convs
    per step, no cface segment), with ``model``'s parameters and batch
    statistics: the same model by another route, and ~20x cheaper on the
    host than the fused route's plain versions at these depths."""
    ref = dt.HealpyGCNN(nside, np.arange(12 * nside * nside), layers,
                        internal_layout="nest", **kw)
    ref.build((1,) + tuple(model._built_input_shape[1:]), device="cpu")
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return ref.double()


def chain_launches(laps, fused_dw=None):
    """Launches of a lap chain of ``laps`` laps: the forward, and with
    ``fused_dw`` set its backward too (K2 a lap; or K1 on dy a lap and no
    K3: the term selector needs no gradient)."""
    want = {"strips": laps, "stencil_conv": laps, "dxdw": 0, "grad": 0,
            "bands": 0}
    if fused_dw is True:
        want.update(strips=2 * laps, dxdw=laps)
    elif fused_dw is False:
        want.update(strips=2 * laps, stencil_conv=2 * laps)
    return want


def quick_start_layers(hp_nn):
    """``examples/quick_start.py``'s classifier at full width."""
    return [
        hp_nn.HealpyChebyshev(K=10, Fout=8, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=16, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=32, activation="relu", use_bn=True),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=10, Fout=32, activation="relu"),
        hp_nn.Flatten(),
        hp_nn.Dense(4),
    ]


def time_routes(config, trainers, x, y, steps=10, warmup=3, batch=16):
    """Host-clock ms per synchronized ``train_on_batch`` of ``batch`` maps
    on each backward route (``config.fused_dw`` True: ``trainers[True]``,
    the K2 route; False: the K1+K3 route): ``warmup`` steps of each, then
    ``steps`` rounds of one step of each, the first route swapped every
    round.  Returns ({route: median ms}, {route: [ms, ...]})."""
    def step(fused, i):
        config.set_fused_dw(fused)
        j = batch * (i % (len(x) // batch))
        trainers[fused].train_on_batch(x[j:j + batch], y[j:j + batch])

    try:
        for i in range(warmup):
            for fused in (True, False):
                step(fused, i)
        times = {True: [], False: []}
        for i in range(steps):
            for fused in ((True, False) if i % 2 == 0 else (False, True)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(fused, i)
                torch.cuda.synchronize()
                times[fused].append((time.perf_counter() - t) * 1e3)
    finally:
        config.set_fused_dw(True)
    return {f: float(np.median(v)) for f, v in times.items()}, times


# (config.fused_dw, name) of the two backward routes
ROUTES = ((True, "k2_route"), (False, "k1k3_route"))


def route_steps(dt, config, hp_nn):
    """The quick_start train step (nside 64, batch 16, phase 5's seeds) on
    both backward routes: host-clock ms (:func:`time_routes`, 20 rounds),
    and per step over 3 profiled steps of each route, twice, its device
    ops, device-busy ms and the 8 host ops with the most self CPU time."""
    nside = 64
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside=nside, indices=np.arange(npix),
                          layers=quick_start_layers(hp_nn))
    model.build((16, npix, 1), seed=11)
    data = np.random.RandomState(12)
    xt = data.normal(size=(64, npix, 1)).astype(np.float32)
    yt = data.randint(0, 4, size=64)
    trainers = {}
    for fused in (True, False):
        m = copy.deepcopy(model)
        m.compile(optimizer=1e-3,
                  loss="sparse_categorical_crossentropy_from_logits")
        trainers[fused] = m._trainer
    med, times = time_routes(config, trainers, xt, yt, steps=20)
    rec = {name: {"ms": med[fused], "steps_ms": times[fused],
                  "device_ops": [], "busy_ms": [], "host_top": []}
           for fused, name in ROUTES}
    # each route profiled twice, in the order K2, K1+K3, K1+K3, K2
    for fused, name in ROUTES + ROUTES[::-1]:
        config.set_fused_dw(fused)
        tr = trainers[fused]
        try:
            ops, busy, _, host = device_profile(
                lambda i: tr.train_on_batch(xt[16 * i:16 * i + 16],
                                            yt[16 * i:16 * i + 16]), 3,
                host=8)
        finally:
            config.set_fused_dw(True)
        rec[name]["device_ops"].append(ops)
        rec[name]["busy_ms"].append(busy)
        rec[name]["host_top"].append(host)
    return rec


# (nside, Fin, Fout, B, K) of the four phase-3 shapes: quick_start convs 1-3
# and the headline conv
KERNEL_SHAPES = [(64, 1, 8, 16, 10), (32, 8, 16, 16, 10), (16, 16, 32, 16, 10),
                 (1024, 4, 4, 4, 5)]
# (n, h, r, K, B, Fin, Fout) where the bfloat16 K1 takes its 2-byte body
# (the float32 bytes do not fit the 2-byte plan): phase 15(d)'s radius-3
# conv, and radius 4 at h = 16, radius 2 at h = 8 and radius 1 at h = 13
# (G = 4) at its widths, and radius 1 at h = 13 at nside 64 (few tiles)
S2_SHAPES = [(256, 12, 3, 5, 4, 4, 4), (256, 16, 4, 5, 4, 4, 4),
             (256, 8, 2, 5, 4, 4, 4), (256, 13, 1, 14, 4, 4, 4),
             (64, 13, 1, 14, 4, 4, 4)]
# (shape as S2_SHAPES', roles) where K2's and K3's bfloat16 launches take
# their 2-byte kernel (the float32 bytes do not fit the 2-byte plan, or
# cost a block an SM): every shape of S2_SHAPES in both roles, K2 at
# quick_start's conv 1 (nside 64, 1 -> 8, batch 16, K=10, h=9), and
# radius 3 and 4 at batch 1 (one window set a lap)
S2_BWD_SHAPES = [(shape, ("K2", "K3")) for shape in S2_SHAPES] + [
    ((64, 9, 1, 10, 16, 1, 8), ("K2",)),
    ((256, 12, 3, 5, 1, 4, 4), ("K2", "K3")),
    ((256, 16, 4, 5, 1, 4, 4), ("K2", "K3"))]


def r3_conv_times(fs, config, dev, rng, cache):
    """Phase 15(d)'s radius-3 conv (the k=40 graph at nside 256, K=5, 4 ->
    4, batch 4, the cface layout) in float32 and each bfloat16 mode: of a
    forward and of a train step (forward and ``autograd.grad`` with a fixed
    cotangent) on each backward route, after warm-up, the device time of
    one call (``*_ms``: the kernels' time, from ``torch.profiler`` over 20
    calls, so that the host's pace does not enter) and its time on the
    host's clock (``*_wall_ms``: CUDA events around 20 calls)."""
    from deepsphere_tpu_torch.graph import build_sphere_graph
    from deepsphere_tpu_torch.ops.stencil import as_tensors, stencil_tables

    n, k40, K = K40_GRAPH
    B, Fin, Fout = 4, 4, 4
    st = build_sphere_graph(n, k=k40, method="grid",
                            cache_dir=cache).deep_stencil(0.75, K)
    tables = as_tensors(stencil_tables(st, bf16_io=True), dev)
    P = fs.cfp_geometry(n, st.n_steps)[1]
    g = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(dev)
    x, cot = g(B * Fin, 12, n, P), g(B * Fout, 12, n, P)
    kernel = g(Fin * K, Fout) / np.sqrt(Fin * K)
    xl, kl = x.clone().requires_grad_(), kernel.clone().requires_grad_()

    def fwd():
        with torch.no_grad():
            return fs.fused_stencil_conv_cfp(st, tables, x, kernel, K,
                                             "cheby", B)

    def step():
        y = fs.fused_stencil_conv_cfp(st, tables, xl, kl, K, "cheby", B)
        return torch.autograd.grad(y, (xl, kl), cot.to(y.dtype))

    def times(rec, name, fn):
        rec[name + "_wall_ms"] = cuda_ms(fn, iters=20, warmup=3)
        rec[name + "_ms"] = device_profile(lambda i: fn(), 20)[1]

    out = {}
    try:
        for mode in ("float32",) + BF_MODES:
            config.set_conv_dtype(mode)
            rec = {}
            times(rec, "forward", fwd)
            for fused_dw, route in ROUTES:
                config.set_fused_dw(fused_dw)
                times(rec, route, step)
            config.set_fused_dw(True)
            out[mode] = rec
    finally:
        config.set_fused_dw(True)
        config.set_conv_dtype("float32")
    return out


def s2_times(fs, dev, rng):
    """K1 at :data:`S2_SHAPES`, K2 and K3 at :data:`S2_BWD_SHAPES`, on
    random arrays (no graph): in each bfloat16 mode the 2-byte kernel's
    device time (graph replay) and a digest of its outputs' bits (K2: dx
    and dW), the float32 K1 where it has a plan, and the bound of each."""
    from types import SimpleNamespace

    from deepsphere_tpu_torch.graph.stencil import stencil_offsets
    from deepsphere_tpu_torch.ops.strips import strip_arrays

    recs = []
    for n, h, r, K, B, Fin, Fout in S2_SHAPES:
        st = SimpleNamespace(nside=n, n_steps=h, radius=r,
                             offsets=stencil_offsets(r))
        npl = (2 * r + 1) ** 2
        P = fs.cfp_geometry(n, h)[1]
        g = lambda *shape: torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)
        xc = g(B * Fin, 12, n, P)
        w32 = g(npl, 12, n + 2 * fs.strip_rows(h, torch.float32), P)
        w16 = fs.reextend_weights(w32, n, fs.strip_rows(h, torch.float32),
                                  fs.strip_rows(h, torch.bfloat16))
        wk3 = g(K, Fin, Fout)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rec = {"shape": f"n={n} h={h} r={r} K={K} B={B} Fin={Fin} "
                        f"Fout={Fout}"}
        if fs._k1_plan(n, h, r, npl, K, B, 12, Fin, Fout, sms) is not None:
            a = (st, "cheby", K, xc, w32, strip_arrays(st, xc), wk3, B)
            rec["k1_f32_ms"] = graph_ms(lambda: fs.run_stencil_kernel(*a))
        else:
            rec["k1_f32_ms"] = None
        # float32 arrays (float32 and the band mode), bfloat16 ones (I/O)
        rec["bound_ms"] = {"f32": k1_bound(st, K, B, Fin, Fout),
                           "io": k1_bound(st, K, B, Fin, Fout, es=2)}
        for sfx, (xb, wb) in (("_bf16", (xc, w32)),
                              ("_bf16_io", (xc.to(torch.bfloat16),
                                            w16.to(torch.bfloat16)))):
            a = (st, "cheby", K, xb, wb, strip_arrays(st, xb), wk3, B,
                 "bfloat16")
            rec["k1" + sfx + "_digest"] = hashlib.sha256(
                fs.run_stencil_kernel(*a).view(torch.int16).cpu().numpy()
                .tobytes()).hexdigest()[:16]
            rec["k1" + sfx + "_ms"] = graph_ms(
                lambda: fs.run_stencil_kernel(*a))
        recs.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    return recs


def s2_bwd_times(fs, dev, rng):
    """K2 and K3 at :data:`S2_BWD_SHAPES` on random arrays (no graph, no
    mask), each in its role and in each bfloat16 mode: the 2-byte kernel's
    device time (graph replay), a digest of its outputs' bits and the
    bound."""
    from types import SimpleNamespace

    from deepsphere_tpu_torch.graph.stencil import stencil_offsets
    from deepsphere_tpu_torch.ops.strips import strip_arrays

    recs = []
    for (n, h, r, K, B, Fin, Fout), roles in S2_BWD_SHAPES:
        st = SimpleNamespace(nside=n, n_steps=h, radius=r,
                             offsets=stencil_offsets(r))
        npl = (2 * r + 1) ** 2
        P = fs.cfp_geometry(n, h)[1]
        g = lambda *shape: torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)
        x, dy = g(B * Fin, 12, n, P), g(B * Fout, 12, n, P)
        w32 = g(npl, 12, n + 2 * fs.strip_rows(h, torch.float32), P)
        w16 = fs.reextend_weights(w32, n, fs.strip_rows(h, torch.float32),
                                  fs.strip_rows(h, torch.bfloat16))
        wk3t = g(K, Fout, Fin)
        for role in roles:
            dx = role == "K2"
            rec = {"shape": f"n={n} h={h} r={r} K={K} B={B} Fin={Fin} "
                            f"Fout={Fout}", "role": role,
                   "bound_ms": {"f32": bwd_bound(st, K, B, Fin, Fout, dx),
                                "io": bwd_bound(st, K, B, Fin, Fout, dx, 2)}}
            for sfx, (xb, dyb, wb) in (
                    ("_bf16", (x, dy, w32)),
                    ("_bf16_io", (x.to(torch.bfloat16), dy.to(torch.bfloat16),
                                  w16.to(torch.bfloat16)))):
                if dx:
                    fn, a = fs.run_dxdw_kernel, (
                        st, "cheby", K, dyb, wb, strip_arrays(st, dyb), wk3t,
                        xb, None, B, "bfloat16")
                else:
                    fn, a = fs.run_grad_kernel, (
                        st, "cheby", K, xb, wb, strip_arrays(st, xb), dyb, B,
                        "bfloat16")
                got = fn(*a)
                got = got if isinstance(got, tuple) else (got,)
                rec["digest" + sfx] = hashlib.sha256(b"".join(
                    o.view(torch.int16).cpu().numpy().tobytes()
                    for o in got)).hexdigest()[:16]
                rec["ms" + sfx] = graph_ms(lambda: fn(*a))
                del got, a
            recs.append(rec)
            print(json.dumps(rec), file=sys.stderr, flush=True)
        del x, dy, w32, w16
        torch.cuda.empty_cache()
    return recs


def band_map(C, F, n, h, P, dev):
    """Flat index into xc (C, F, n, P) of every element of K5's packed bands
    (F, C, 4hn), face col y at lane y + h (the yardstick's map)."""
    hn = torch.arange(h * n, device=dev)
    rows = torch.cat([hn // n, n - h + hn // n, hn // h, hn // h])
    cols = torch.cat([hn % n, hn % n, hn % h, n - h + hn % h]) + h
    f = torch.arange(F, device=dev)[:, None, None]
    c = torch.arange(C, device=dev)[None, :, None]
    return (((c * F + f) * n + rows) * P + cols).reshape(-1)


def kernel_times(root, s2_only=False):
    """``--kernel-times ROOT``: device times (graph replay) of K1-K5 and of
    the ``index_select`` of K4's and K5's maps at the four phase-3 shapes
    (K5 on the B*Fin channels of the conv's input, 12 faces), of K1 as
    the dx conv of the K1+K3 route (on dy, through W^T) and of K1, K2 and
    K3 in each bfloat16 mode (phase 15(a)'s inputs: the same activations,
    as float32 or bfloat16, the weight planes rounded into the R16 layout),
    with a digest of each bfloat16 output's bytes (K2: dx and dW), and the
    quick_start train step
    on both routes (:func:`route_steps`), with the package imported from the
    checkout ``ROOT`` (this one or another commit's); with ``s2_only``
    (``--s2``) only the 2-byte kernels at :data:`S2_SHAPES` and
    :data:`S2_BWD_SHAPES` and the radius-3 conv.  Prints
    one JSON line."""
    import inspect

    sys.path.insert(0, os.path.abspath(root))
    import deepsphere_tpu_torch as dt
    from deepsphere_tpu_torch import config
    from deepsphere_tpu_torch.graph import build_sphere_graph
    from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
    from deepsphere_tpu_torch.ops import _cuda
    from deepsphere_tpu_torch.ops import fused_stencil as fs
    from deepsphere_tpu_torch.ops.stencil import (
        as_tensors,
        pack_edge_bands,
        stencil_tables,
    )
    from deepsphere_tpu_torch.ops.strips import build_strips, strip_arrays

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _cuda.lib()
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")
    rng = np.random.RandomState(1234)
    out = {"root": root, "package": os.path.dirname(dt.__file__),
           "card": card_line(), "shapes": []}
    # a checkout whose kernels still read device tap offsets takes them
    takes = lambda fn: "offsets" in inspect.signature(fn).parameters
    for n, Fin, Fout, B, K in [] if s2_only else KERNEL_SHAPES:
        st = build_sphere_graph(n, k=8, method="grid",
                                cache_dir=cache).deep_stencil(0.75, K)
        h = st.n_steps
        _, P_l = fs.cfp_geometry(n, h)
        tables = as_tensors(stencil_tables(st), dev)
        offs, w, idx = tables["offsets"], tables["weights"], tables["strip_idx"]
        mask = tables.get("corr_mask")
        xc = torch.from_numpy(
            rng.normal(size=(B * Fin, 12, n, P_l)).astype(np.float32)).to(dev)
        dy = torch.from_numpy(
            rng.normal(size=(B * Fout, 12, n, P_l)).astype(np.float32)).to(dev)
        kernel = torch.from_numpy((rng.normal(size=(Fin * K, Fout))
                                   / np.sqrt(Fin * K)).astype(np.float32)).to(dev)
        wk3 = kernel.reshape(Fin, K, Fout).permute(1, 0, 2).contiguous()
        wk3t = kernel.reshape(Fin, K, Fout).permute(1, 2, 0).contiguous()
        strips = strip_arrays(st, xc)
        slab = 12 * n * P_l
        xz = torch.cat([xc.reshape(B * Fin, slab),
                        xc.new_zeros((B * Fin, 1))], dim=1)
        sel = torch.where(idx >= 0, idx, slab).long()
        args = (st, "cheby", K, xc, w, strips, wk3, B)
        kw = lambda fn: {"offsets": offs} if takes(fn) else {}
        a2 = (st, "cheby", K, dy, w, strip_arrays(st, dy), wk3t, xc, mask, B)
        a3 = (st, "cheby", K, xc, w, strips, dy, B)
        # the dx conv of the K1+K3 route: K1 on dy through W^T
        a1t = (st, "cheby", K, dy, w, strip_arrays(st, dy), wk3t, B)
        bflat = xc.reshape(-1)
        bidx = band_map(B * Fin, 12, n, h, P_l, dev)
        rec = {"shape": f"nside={n} B={B} Fin={Fin} Fout={Fout} K={K}",
               "k4_ms": graph_ms(lambda: build_strips(st, xc, idx)),
               "index_select_ms": graph_ms(
                   lambda: torch.index_select(xz, 1, sel)),
               "k1_ms": graph_ms(lambda: fs.run_stencil_kernel(
                   *args, **kw(fs.run_stencil_kernel))),
               "k1_dx_ms": graph_ms(lambda: fs.run_stencil_kernel(
                   *a1t, **kw(fs.run_stencil_kernel))),
               "k2_ms": graph_ms(lambda: fs.run_dxdw_kernel(
                   *a2, **kw(fs.run_dxdw_kernel))),
               "k3_ms": graph_ms(lambda: fs.run_grad_kernel(
                   *a3, **kw(fs.run_grad_kernel))),
               "k5_ms": graph_ms(lambda: pack_edge_bands(xc, n, h)),
               "k5_index_select_ms": graph_ms(
                   lambda: torch.index_select(bflat, 0, bidx))}
        # K1, K2 and K3 in each bfloat16 mode: the band mode on xc and dy,
        # the I/O mode on them in bfloat16 with their R16 strips and weight
        # planes
        x16, dy16 = xc.to(torch.bfloat16), dy.to(torch.bfloat16)
        w16 = fs._io_weights(st, {"weights": w}, torch.bfloat16)
        for sfx, (xb, dyb, wb) in (("_bf16", (xc, dy, w)),
                                   ("_bf16_io", (x16, dy16, w16))):
            sxb, sdyb = strip_arrays(st, xb), strip_arrays(st, dyb)
            calls = {
                "k1": (fs.run_stencil_kernel, (st, "cheby", K, xb, wb, sxb,
                                               wk3, B, "bfloat16")),
                "k2": (fs.run_dxdw_kernel, (st, "cheby", K, dyb, wb, sdyb,
                                            wk3t, xb, mask, B, "bfloat16")),
                "k3": (fs.run_grad_kernel, (st, "cheby", K, xb, wb, sxb, dyb,
                                            B, "bfloat16"))}
            for kn, (fn, a) in calls.items():
                got = fn(*a)
                got = got if isinstance(got, tuple) else (got,)
                rec[kn + sfx + "_digest"] = hashlib.sha256(b"".join(
                    o.view(torch.int16).cpu().numpy().tobytes()
                    for o in got)).hexdigest()[:16]
                rec[kn + sfx + "_ms"] = graph_ms(lambda: fn(*a))
                del got
            del calls, sxb, sdyb
        out["shapes"].append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
        del xc, dy, xz, sel, strips, tables, a1t, a2, a3, args, bflat, bidx
        del x16, dy16, w16
        torch.cuda.empty_cache()
    out["s2_shapes"] = s2_times(fs, dev, rng)
    out["s2_bwd_shapes"] = s2_bwd_times(fs, dev, rng)
    out["r3_conv"] = r3_conv_times(fs, config, dev, rng, cache)
    print(json.dumps(out["r3_conv"]), file=sys.stderr, flush=True)
    if not s2_only:
        out["train_step"] = route_steps(dt, config, hp_nn)
        print(json.dumps(out["train_step"]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def _peak_sites(snap, root, ours=("deepsphere_tpu_torch", "chip_smoke")):
    """The allocations live at the peak of a recorded allocator trace
    (``torch.cuda.memory._snapshot()``), counted from where the recording
    began: (peak bytes, [(site, bytes, blocks)] largest first).  A site is
    the innermost Python frame in this repo's code with its function, else
    the innermost frame at all, else "no Python frame" (an op that the
    autograd engine runs in C++)."""
    cur = peak = 0
    live, at_peak = {}, {}
    for e in snap["device_traces"][0]:
        if e["action"] == "alloc":
            cur += e["size"]
            live[e["addr"]] = e
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif e["action"] == "free_requested":
            cur -= e["size"]
            live.pop(e["addr"], None)
    sites = {}
    for e in at_peak.values():
        frames = e.get("frames") or []
        mine = [f for f in frames if any(o in f["filename"] for o in ours)]
        f = (mine or frames or [None])[0]
        if f is None:
            site = "no Python frame"
        else:
            fn = f["filename"]
            fn = (os.path.relpath(fn, root) if fn.startswith(root)
                  else os.path.basename(fn))
            site = f"{fn}:{f['line']} {f['name']}"

        b, n = sites.get(site, (0, 0))
        sites[site] = (b + e["size"], n + 1)
    return peak, sorted(((s, b, n) for s, (b, n) in sites.items()),
                        key=lambda t: -t[1])


def memory_report(out_path=None):
    """``--memory [OUT.json]``: where the device memory of one train step
    of quick_start on the k=8 kNN graph (nside 64, batch 16, phase 14's
    model) peaks, on each backward route, with and without remat.  Each
    setting takes two steps of a fresh copy; the allocator records the
    second (Adam's state and the graph tables are then in place), and the
    allocations live at its peak are summed by the code that made them.
    Prints the table and writes it to ``out_path`` if given."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import deepsphere_tpu_torch as dt
    from deepsphere_tpu_torch import config
    from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
    from deepsphere_tpu_torch.ops import _cuda

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = card_line()
    _cuda.build()
    _cuda.lib()
    nside = 64
    npix = 12 * nside * nside
    init = dt.HealpyGCNN(nside, np.arange(npix), quick_start_layers(hp_nn),
                         n_neighbors=8, graph_method="knn")
    init.build((16, npix, 1), seed=41)
    data = np.random.RandomState(43)
    xt = data.normal(size=(32, npix, 1)).astype(np.float32)
    yt = data.randint(0, 4, size=32)
    rows = []
    try:
        for fused in (True, False):
            for remat in (False, True):
                config.set_fused_dw(fused)
                m = copy.deepcopy(init)
                m.remat = remat
                m.compile(optimizer=1e-3,
                          loss="sparse_categorical_crossentropy_from_logits")
                peaks = []
                for i in range(2):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    if i == 1:
                        torch.cuda.memory._record_memory_history(
                            enabled="all", context="all", stacks="python",
                            max_entries=1_000_000)
                    m._trainer.train_on_batch(xt[16 * i:16 * i + 16],
                                              yt[16 * i:16 * i + 16])
                    torch.cuda.synchronize()
                    peaks.append(torch.cuda.max_memory_allocated(dev) - base)
                snap = torch.cuda.memory._snapshot()
                torch.cuda.memory._record_memory_history(enabled=None)
                peak, sites = _peak_sites(snap, here)
                row = {"fused_dw": fused, "remat": remat,
                       "held_before_step": base, "peak_step1": peaks[0],
                       "peak_step2": peaks[1], "peak_traced": peak,
                       "sites": [{"site": s, "bytes": b, "blocks": n}
                                 for s, b, n in sites[:12]]}
                rows.append(row)
                say("memory", f"{'K2' if fused else 'K1+K3'} route, remat="
                    f"{remat}: peak over the bytes held before the step "
                    f"{peaks[0]} (step 1), {peaks[1]} (step 2; traced "
                    f"{peak}), {base} held; live at the peak:")
                for s, b, n in sites[:12]:
                    print(f"    {b:>12d} B in {n:>4d} blocks  {s}")
                del m
    finally:
        config.set_fused_dw(True)
    summary = {"card": card, "model": "quick_start, k=8 kNN graph, nside 64,"
               " batch 16", "rows": rows}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1)
    print(card)
    print(json.dumps({"memory": [{k: r[k] for k in (
        "fused_dw", "remat", "peak_step1", "peak_step2")} for r in rows]}))


def compare(parent, out_path=None, s2_only=False):
    """``--compare PARENT [OUT.json] [--s2]``: :func:`kernel_times` of the
    checkout PARENT and of this one in turns (parent, this, this, parent),
    each in its own process, and whether each bfloat16 kernel's outputs
    (K1's y, K2's dx and dW, K3's dW) are bit for bit the same in all four
    runs; with ``--s2`` only the 2-byte kernels and the radius-3 conv.
    Prints the pairs and writes them to ``out_path`` if given."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for root in (parent, here, here, parent):
        cmd = [sys.executable, os.path.abspath(__file__), "--kernel-times",
               root] + (["--s2"] if s2_only else [])
        t = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800)
        if res.returncode != 0:
            raise SystemExit(f"{cmd} failed:\n{res.stdout[-4000:]}\n"
                             f"{res.stderr[-8000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        say("compare", f"{root}: {time.perf_counter() - t:.1f} s")
    keys = ("k1_ms", "k4_ms", "index_select_ms", "k1_dx_ms", "k2_ms", "k3_ms",
            "k5_ms", "k5_index_select_ms") + tuple(
                f"{kn}{sfx}_ms" for kn in ("k1", "k2", "k3")
                for sfx in ("_bf16", "_bf16_io"))
    pairs = []
    for j, shape in enumerate([] if s2_only else KERNEL_SHAPES):
        row = {"shape": runs[0]["shapes"][j]["shape"]}
        for k in keys:
            row[k] = {"parent": [runs[0]["shapes"][j][k], runs[3]["shapes"][j][k]],
                      "change": [runs[1]["shapes"][j][k], runs[2]["shapes"][j][k]]}
        for kn in ("k1", "k2", "k3"):
            for sfx in ("_bf16", "_bf16_io"):
                digests = {runs[i]["shapes"][j][kn + sfx + "_digest"]
                           for i in range(4)}
                row[kn + sfx + "_bit_equal"] = len(digests) == 1
        pairs.append(row)
        say("compare", json.dumps(row))
    s2 = []
    for j, _ in enumerate(S2_SHAPES):
        recs = [run["s2_shapes"][j] for run in runs]
        row = {"shape": recs[0]["shape"], "bound_ms": recs[0]["bound_ms"]}
        for k in ("k1_f32_ms", "k1_bf16_ms", "k1_bf16_io_ms"):
            row[k] = {"parent": [recs[0][k], recs[3][k]],
                      "change": [recs[1][k], recs[2][k]]}
        for sfx in ("_bf16", "_bf16_io"):
            row["k1" + sfx + "_bit_equal"] = len(
                {rec["k1" + sfx + "_digest"] for rec in recs}) == 1
        s2.append(row)
        say("compare", json.dumps(row))
    for j, _ in enumerate(runs[0]["s2_bwd_shapes"]):
        recs = [run["s2_bwd_shapes"][j] for run in runs]
        row = {"shape": recs[0]["shape"], "role": recs[0]["role"],
               "bound_ms": recs[0]["bound_ms"]}
        for sfx in ("_bf16", "_bf16_io"):
            row["ms" + sfx] = {"parent": [recs[0]["ms" + sfx],
                                          recs[3]["ms" + sfx]],
                               "change": [recs[1]["ms" + sfx],
                                          recs[2]["ms" + sfx]]}
            row["bit_equal" + sfx] = len(
                {rec["digest" + sfx] for rec in recs}) == 1
        s2.append(row)
        say("compare", json.dumps(row))
    conv = {mode: {k: {"parent": [runs[0]["r3_conv"][mode][k],
                                  runs[3]["r3_conv"][mode][k]],
                       "change": [runs[1]["r3_conv"][mode][k],
                                  runs[2]["r3_conv"][mode][k]]}
                   for k in runs[0]["r3_conv"][mode]}
            for mode in runs[0]["r3_conv"]}
    say("compare", "radius-3 conv, ms: " + json.dumps(conv))
    steps = {}
    for _, route in [] if s2_only else ROUTES:
        steps[route] = {
            k: {"parent": [runs[0]["train_step"][route][k],
                           runs[3]["train_step"][route][k]],
                "change": [runs[1]["train_step"][route][k],
                           runs[2]["train_step"][route][k]]}
            for k in ("ms", "busy_ms", "device_ops", "steps_ms", "host_top")}
    if steps:
        say("compare", "quick_start train step, ms: " + json.dumps(
            {r: v["ms"] for r, v in steps.items()}))
    summary = {"card": runs[0]["card"], "order": "parent, change, change, parent",
               "shapes": pairs, "s2_shapes": s2, "r3_conv": conv,
               "train_step": steps}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)


AB_BITS = [  # (n, h, r, K, B, Fin, Fout): odd and even h, radius 1-4
    (16, 9, 1, 10, 2, 3, 9), (32, 4, 1, 5, 2, 4, 4), (64, 9, 1, 10, 1, 1, 8),
    (32, 9, 1, 10, 16, 8, 16), (16, 7, 1, 8, 2, 4, 4), (32, 8, 2, 5, 1, 2, 3),
    (32, 6, 2, 4, 2, 2, 2), (16, 3, 3, 2, 2, 2, 3), (16, 4, 4, 2, 1, 2, 2),
    (32, 12, 3, 5, 2, 2, 3),
    # the 2-byte kernels' window sets with partial ones: at radius 3 blocks
    # of 10 and 1 batch indices (4 a lap, 4, 2; 1), at radius 4 of 3 (2, 1)
    (64, 12, 3, 5, 11, 2, 3), (64, 16, 4, 5, 3, 2, 2)]

# what ``--ab KERNEL`` builds: the kernels' sources, the header an
# EDITS.json edits, the C entry points' sources, the roles (K1; K2 and K3,
# the two modes of the backward template) and how the 2-byte kernels are
# reached: K1's C entry picks its staging itself, so by a build with that
# line forced (the file, the line and its forced form); K2's and K3's take
# it from the caller (prec 3 and 4), so from the same build
AB_KERNELS = {
    "k1": (("stencil_conv*.cu",), "stencil_conv.cuh", ("stencil_conv.cu",),
           ("K1",), ("stencil_conv.cu",
                     "const bool two = mode && smem_of(sizeof(float)) > "
                     "kSmemMax;", "const bool two = mode;")),
    "bwd": (("stencil_dxdw*.cu", "stencil_grad*.cu"), "stencil_bwd.cuh",
            ("stencil_dxdw.cu", "stencil_grad.cu"), ("K2", "K3"), None),
}


def ab(kernel, edit_files, parent=None, s2_only=False):
    """``--ab KERNEL [EDITS.json ...] [--parent DIR] [--s2]``: the
    bfloat16 stagings of K1 (``k1``) or of K2 and K3 (``bwd``) against
    their 2-byte kernels, bit for bit and in turns (module docstring).  A
    variant recompiles the bfloat16 sources and the C entries, so its edits
    may change either staging.  ``--parent DIR`` adds the same kernels'
    sources of the checkout DIR (another commit) as they are, variant
    ``parent`` (and, for ``bwd``, its 2-byte kernels forced as ``s2`` is,
    ``parent_s2``); with no EDITS.json, ``bwd``'s variants come from the
    libraries the two checkouts build themselves (as ``--sass`` builds
    them).  ``--s2`` times only at :data:`S2_SHAPES` (``k1``) or
    :data:`S2_BWD_SHAPES` (``bwd``)."""
    import ctypes
    import glob
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from deepsphere_tpu_torch.ops import _cuda
    from deepsphere_tpu_torch.ops import fused_stencil as fs

    if kernel not in AB_KERNELS:
        raise SystemExit(f"--ab: KERNEL is one of {list(AB_KERNELS)}, "
                         f"got {kernel!r}")
    globs, header, entries, roles, force = AB_KERNELS[kernel]
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    csrc = os.path.join(here, "deepsphere_tpu_torch", "csrc")
    srcs = sorted({os.path.basename(f) for g in globs
                   for f in glob.glob(os.path.join(csrc, g))})
    bf16 = [f for f in srcs if "_bf16" in f]
    work = tempfile.mkdtemp(prefix=f"ds_ab_{kernel}_")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")

    def tree(name, fn, edits):
        d = os.path.join(work, name)
        shutil.copytree(csrc, d)
        text = open(os.path.join(d, fn)).read()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"--ab {name}: {old!r} not in {fn}")
            text = text.replace(old, new)
        open(os.path.join(d, fn), "w").write(text)
        return d

    # each variant recompiles only the files its edits can change;
    # the parent's tree builds its own sources
    trees = {"this": (tree("this", header, []), srcs)}
    psrcs = []
    if parent:
        d = os.path.join(work, "parent")
        shutil.copytree(os.path.join(os.path.abspath(parent),
                                     "deepsphere_tpu_torch", "csrc"), d)
        psrcs = sorted({os.path.basename(f) for g in globs
                        for f in glob.glob(os.path.join(d, g))})
        trees["parent"] = (d, psrcs)
    if force:
        trees["s2"] = (tree("s2", force[0], [force[1:]]), list(entries))
    # an edit inside the header's 2-byte kernel (K1's body, or K2's and
    # K3's kernel, from its first line below) changes only its sources
    hdr = open(os.path.join(csrc, header)).read()
    s2_at = max(hdr.find("// The 2-byte body of the bfloat16 K1"),
                hdr.find("// The 2-byte bfloat16 kernel: its arguments"))
    for path in edit_files:
        name = os.path.splitext(os.path.basename(path))[0]
        edits = json.load(open(path))
        own = bf16
        if s2_at >= 0 and all(hdr.find(old) > s2_at for old, _ in edits):
            own = [f for f in bf16 if "_s2" in f]
        trees[name] = (tree(name, header, edits), sorted(set(own) | set(entries)))
    try:
        t = time.perf_counter()
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # no variant to compile (bwd, no EDITS.json): the libraries the
        # checkouts build themselves, the parent's shared with --sass
        own = not edit_files and not force
        procs = [] if own else [(name, d, f, subprocess.Popen(
            [nvcc, *_cuda._FLAGS, "-I", d, "-c", "-o",
             os.path.join(d, f + ".o"), os.path.join(d, f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for name, (d, fs_) in trees.items() for f in fs_]
        ptxas = []
        for name, d, f, proc in procs:
            out = proc.communicate(timeout=900)[0]
            if proc.returncode:
                raise SystemExit(f"--ab {name}: nvcc {f} failed:\n{out}")
            ptxas.append(f"== {name} {f}\n{out}")
        libs = {}
        for name, (d, fs_) in trees.items():
            if own:
                so = _library(parent if name == "parent" else here)
            else:
                so = os.path.join(d, f"{kernel}.so")
                objs = [os.path.join(d if f in fs_ else trees["this"][0],
                                     f + ".o")
                        for f in (psrcs if name == "parent" else srcs)]
                subprocess.run([nvcc, *_cuda._FLAGS, "-shared", "-o", so,
                                *objs], check=True, capture_output=True,
                               timeout=600)
            lib = ctypes.CDLL(so)
            for fn, nptr in (("ds_stencil_conv", 7), ("ds_stencil_dxdw", 11),
                             ("ds_stencil_grad", 8)):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = [vp] * nptr + [ci] * 17 + [vp]
                    getattr(lib, fn).restype = ci
            libs[name] = lib
        say("ab", f"{kernel}: built {list(libs)} in "
            f"{time.perf_counter() - t:.1f} s")
        # variant -> (its library, whether the caller names the 2-byte
        # staging; None: the staging the shape gets)
        variants = {k: (lib, None) for k, lib in libs.items()}
        if not force:
            variants = {"s2": (libs["this"], True), **variants}
            if "parent" in libs:
                variants["parent_s2"] = (libs["parent"], True)
        rng = np.random.RandomState(5)

        def case(n, h, r, K, B, Fin, Fout, io, role):
            """Random arrays of one launch of ``role``: its recursion input
            ``src`` (C channels) with strips and weight planes, in the
            mode's dtype, and what the role folds or contracts with."""
            dt_ = torch.bfloat16 if io else torch.float32
            P = fs.cfp_geometry(n, h)[1]
            R = fs.strip_rows(h, dt_)
            g = lambda *shape, d=dt_: torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)).to(dev).to(d)
            # (recursion, other) channels
            Crec, Cch = (Fout, Fin) if role == "K2" else (Fin, Fout)
            C = B * Crec
            c = {"src": g(C, 12, n, P), "top": g(C, 12, R, P),
                 "bot": g(C, 12, R, P), "ls": g(C, 12, n, 128),
                 "wext": g((2 * r + 1) ** 2, 12, n + 2 * R, P),
                 "dims": (n, h, r, K, B, Crec, Cch, R, P)}
            if role == "K1":
                c["wk"] = g(K, Fin, Fout, d=torch.float32)
                c["out"] = torch.empty((B * Fout, 12, n, P), dtype=dt_,
                                       device=dev)
            else:
                c["oth"] = g(B * Cch, 12, n, P)
            if role == "K2":
                c["wk"] = g(K, Crec, Cch, d=torch.float32)
                c["mask"] = torch.from_numpy(
                    (rng.uniform(size=(12, n, P)) > 0.1).astype(np.float32)
                ).to(dev)
                c["out"] = torch.empty((B * Cch, 12, n, P), dtype=dt_,
                                       device=dev)
            return c

        def launcher(lib, c, mode, role, two=None):
            """(go, plan, outputs, staged): ``go()`` launches ``role`` on
            ``c`` in precision ``mode`` with ``lib``'s kernels, the backward
            in 2-byte staging where ``two`` (None: as the shape gets it);
            outputs are the tensors it writes, staged the bytes a staged
            value takes."""
            n, h, r, K, B, Crec, Cch, R, P = c["dims"]
            npl = (2 * r + 1) ** 2
            es = 2 if mode else 4
            head = [c[k].data_ptr() for k in ("src", "top", "bot", "ls",
                                              "wext")]
            tail = (n, h, R, P)
            prec = mode
            if role == "K1":
                plan = fs._k1_plan(n, h, r, npl, K, B, 12, Crec, Cch, sms, es)
                staged = mode and fs._k1_bf16_staging(plan, h, r, npl, K)
                outs = (c["out"],)
                fn = lib.ds_stencil_conv
                ptrs = head + [c["wk"].data_ptr(), c["out"].data_ptr()]
            else:
                dx = role == "K2"
                plan = fs._bwd_plan(n, h, r, npl, K, B, 12, Crec, Cch, dx, sms,
                                    es)
                staged = mode and fs._bwd_bf16_staging(plan, h, r, npl, K,
                                                       Crec, dx)
                if mode and (staged == 2 if two is None else two):
                    prec += 2
                ncol = -(-B // plan.GB) * 12 * (n // plan.T) ** 2
                part = torch.empty((K * Crec * Cch, ncol), device=dev)
                dw = torch.empty((K * Crec * Cch,), device=dev)
                if dx:
                    fn = lib.ds_stencil_dxdw
                    outs = (c["out"], dw)
                    ptrs = head + [c["wk"].data_ptr(), c["oth"].data_ptr(),
                                   c["mask"].data_ptr(), c["out"].data_ptr(),
                                   part.data_ptr(), dw.data_ptr()]
                else:
                    fn = lib.ds_stencil_grad
                    outs = (dw,)
                    ptrs = head + [c["oth"].data_ptr(), part.data_ptr(),
                                   dw.data_ptr()]

            def go():
                rc = fn(*ptrs, 0, K, r, npl, B, 12, Crec, Cch, *tail, plan.T,
                        plan.G, plan.GB, plan.FC, prec,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"--ab {role}: CUDA error {rc}")
            # the launch writes its scratch by pointer: keep the tensors
            # alive as long as go is (freed, a later empty_cache unmaps them)
            go.keep = (c, None if role == "K1" else (part, dw))
            return go, plan, outs, staged

        out = {"card": card_line(), "kernel": kernel, "bits": [], "times": []}
        for shape in AB_BITS:
            for role in roles:
                for io in (False, True):
                    c = case(*shape, io, role)
                    got = {}
                    for name, (lib, two) in variants.items():
                        if "out" in c:
                            c["out"].fill_(7.0)
                        go, plan, outs, staged = launcher(
                            lib, c, 2 if io else 1, role, two)
                        go()
                        got[name] = [o.view(torch.int16).clone() for o in outs]
                        if name == "this":
                            staged_this = staged
                    equal = {k: all(torch.equal(a, b)
                                    for a, b in zip(v, got["s2"]))
                             for k, v in got.items() if k != "s2"}
                    out["bits"].append({
                        "shape": shape, "role": role, "io": io,
                        "plan": list(plan[:4]),
                        "staged": staged_this, "equal": equal})
                    del c, got
        say("ab", "bit for bit against the 2-byte kernels: " + "; ".join(
            f"{b['shape']} {b['role']} {'I/O' if b['io'] else 'band'} staged "
            f"{b['staged']} {b['equal']}" for b in out["bits"]))
        # the phase-3 shapes, and the shapes of the 2-byte kernels
        shapes = [((n, K - 1, 1, K, B, Fin, Fout), roles)
                  for n, Fin, Fout, B, K in ([] if s2_only else KERNEL_SHAPES)]
        shapes += ([(shape, roles) for shape in S2_SHAPES] if kernel == "k1"
                   else S2_BWD_SHAPES)
        for shape, shape_roles in shapes:
            n, h, r, K, B, Fin, Fout = shape
            npl = (2 * r + 1) ** 2
            for role in shape_roles:
                row = {"shape": f"nside={n} h={h} r={r} B={B} Fin={Fin} "
                                f"Fout={Fout} K={K}", "role": role}
                c32 = case(*shape, False, role)
                # the float32 kernel where it has a plan
                plan32 = (fs._k1_plan(n, h, r, npl, K, B, 12, Fin, Fout, sms)
                          if role == "K1" else fs._bwd_plan(
                              n, h, r, npl, K, B, 12,
                              *((Fout, Fin) if role == "K2" else (Fin, Fout)),
                              role == "K2", sms))
                row["f32"] = (None if plan32 is None else
                              graph_ms(launcher(libs["this"], c32, 0, role)[0]))
                for io in (False, True):
                    c = case(*shape, True, role) if io else c32
                    fns = {k: launcher(lib, c, 2 if io else 1, role, two)[0]
                           for k, (lib, two) in variants.items()}
                    order = ["s2"] + [k for k in fns if k != "s2"]
                    times = {k: [] for k in fns}
                    for k in order + order[::-1]:
                        times[k].append(graph_ms(fns[k]))
                    row["I/O" if io else "band"] = times
                    del c, fns
                del c32
                torch.cuda.empty_cache()
                out["times"].append(row)
                say("ab", json.dumps(row))
        os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
        with open(os.path.join(here, "chiprun_out", f"ab_{kernel}.json"),
                  "w") as fh:
            json.dump(out, fh, indent=1)
        with open(os.path.join(here, "chiprun_out",
                               f"ab_{kernel}_ptxas.log"), "w") as fh:
            fh.write("".join(ptxas))
        bad = [b for b in out["bits"] if not all(b["equal"].values())]
        print(json.dumps({"ab": kernel, "times": out["times"],
                          "bits_differ": bad}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _sass_bodies(libs):
    """[{function: a digest of its instructions}] of each kernel library in
    ``libs`` (``cuobjdump -sass``, the libraries disassembled at once and
    read line by line; addresses and encodings stripped)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    procs = [subprocess.Popen([cuobjdump, "-sass", lib],
                              stdout=subprocess.PIPE, text=True,
                              bufsize=1 << 20) for lib in libs]

    def read(proc):
        funcs, name, h = {}, None, None
        for ln in proc.stdout:
            at = ln.find("Function : ")
            if at >= 0:
                if name:
                    funcs[name] = h.hexdigest()
                name, h = ln[at + 11:].strip(), hashlib.sha256()
                continue
            semi = ln.find(";")
            if name is None or semi < 0:
                continue
            ins = ln[ln.find("*/") + 2:semi].strip()  # after the address
            if ins and (ins[0] == "@" or "A" <= ins[0] <= "Z"):
                h.update(ins.encode() + b"\n")
        if name:
            funcs[name] = h.hexdigest()
        if proc.wait() != 0:
            raise SystemExit(f"cuobjdump failed: {proc.args}")
        return funcs

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(procs)) as pool:
        return list(pool.map(read, procs))


def _library(root):
    """The kernel library of the checkout ``root``, built (once: it is
    cached there) by a process of its own."""
    code = ("import sys; sys.path.insert(0, {r!r}); "
            "from deepsphere_tpu_torch.ops import _cuda; "
            "print(_cuda.build()[0])").format(r=os.path.abspath(root))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=1200, check=True)
    return res.stdout.strip().splitlines()[-1]


def sass_check(parent, out_path=None):
    """``--sass PARENT [OUT.json]``: the machine code of every kernel of the
    checkout PARENT's library against this checkout's: how many of the
    parent's functions this library holds instruction for instruction
    (matched by their code, since template parameters change the names),
    which do not, and how many functions this one adds."""
    here = os.path.dirname(os.path.abspath(__file__))
    par, chg = _sass_bodies([_library(root) for root in (parent, here)])
    bodies = set(chg.values())
    differ = sorted(k for k, v in par.items() if v not in bodies)
    summary = {"parent": os.path.abspath(parent), "parent_functions": len(par),
               "identical": len(par) - len(differ), "differ": differ,
               "functions": len(chg), "added": len(chg) - len(par)}
    say("sass", json.dumps(summary))
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(summary, fh, indent=1)


K40_GRAPH = (256, 40, 5)  # phase 9(a): nside, k, K


def prebuild_headline(root):
    """Build the headline conv's nside-1024 grid graph and its deep stencil
    (K=5) in another process, into ``ROOT/.bench_cache``, beside the kernels'
    build and phases 3-5 (minutes of host time); phase 3's headline case,
    run after phase 5, loads it.  Returns the process."""
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "from deepsphere_tpu_torch.graph import build_sphere_graph; "
            "build_sphere_graph(1024, k=8, method='grid', cache_dir={cache!r})"
            ".deep_stencil(0.75, 5)").format(
                root=root, cache=os.path.join(root, ".bench_cache"))
    return subprocess.Popen([sys.executable, "-c", code])


def prebuild_k40(root):
    """Build phase 9(a)'s k=40 graph and its two stencils in another
    process, into ``ROOT/.bench_cache`` (ARPACK's lmax of the nside-256
    graph takes minutes of host time; built beside phases 3-8, phase 9
    loads it).  Returns the process."""
    n, k, K = K40_GRAPH
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "from deepsphere_tpu_torch.graph import build_sphere_graph; "
            "g = build_sphere_graph({n}, k={k}, method='grid', "
            "cache_dir={cache!r}); g.face_stencil(0.75); "
            "g.deep_stencil(0.75, {K})").format(
                root=root, n=n, k=k, K=K,
                cache=os.path.join(root, ".bench_cache"))
    return subprocess.Popen([sys.executable, "-c", code])


SMOOTH = (1024, 10.0)  # phase 11(a): nside, sigma (arcmin), bench.py:569-604


def prebuild_smoothing(root):
    """Build phase 11(a)'s smoothing operator (nside 1024, sigma 10', the
    stencil method: the native template, then its stencil extraction) in
    another process, into ``ROOT/.bench_cache``, with the seconds of the
    build in ``smooth_build.json`` there.  Returns the process."""
    n, sigma = SMOOTH
    cache = os.path.join(root, ".bench_cache")
    code = (
        "import json, os, sys, time\n"
        f"sys.path.insert(0, {root!r})\n"
        "import numpy as np\n"
        "from deepsphere_tpu_torch.nn.smoothing import SmoothingOperator\n"
        "t = time.perf_counter()\n"
        f"SmoothingOperator(nside={n}, indices=np.arange({12 * n * n}), "
        f"sigma={sigma}, method='stencil', data_path={cache!r})\n"
        "secs = time.perf_counter() - t\n"
        f"json.dump(secs, open(os.path.join({cache!r}, 'smooth_build.json'), "
        "'w'))\n")
    return subprocess.Popen([sys.executable, "-c", code])


def kitchen_sink_layers(hp_nn):
    """The reference's every-layer network (``tests/test_networks.py:28-43``,
    its widths)."""
    return [
        hp_nn.HealpyPseudoConv(p=1, Fout=4),
        hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=5, Fout=8),
        hp_nn.Healpy_ViT(p=2, key_dim=8, num_heads=2, n_layers=2),
        hp_nn.HealpyPseudoConv_Transpose(p=2, Fout=16),
        hp_nn.HealpyPseudoConv(p=2, Fout=16),
        hp_nn.HealpyMonomial(K=5, Fout=32),
        hp_nn.HealpyBernstein(K=5, Fout=32),
        hp_nn.Healpy_Transformer(key_dim=8, num_heads=4),
        hp_nn.Healpy_ResidualLayer("CHEBY", layer_kwargs={"K": 5}),
        hp_nn.Flatten(),
        hp_nn.Dense(4),
    ]


def smoothing_and_attention(dev, card, rng, prebuild_s):
    """Phases 11 and 12: smoothing at bench.py's configuration on K4 + K1
    with its transpose backward, masked and ELLPACK smoothing, and the
    kitchen-sink network served and trained at nside 256.  Returns the
    launches of each main path and the times."""
    import deepsphere_tpu_torch as dt
    from deepsphere_tpu_torch import config
    from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
    from deepsphere_tpu_torch.nn.smoothing import (
        HealpySmoothing,
        SmoothingOperator,
        _stencil_decomposition,
        _template_ellpack,
        _with_apps,
    )
    from deepsphere_tpu_torch.ops import _cuda
    from deepsphere_tpu_torch.ops import fused_stencil as fs
    from deepsphere_tpu_torch.ops.smoothing import (
        smooth_chain,
        smooth_chain_plain,
    )
    from deepsphere_tpu_torch.ops.strips import build_strips
    from deepsphere_tpu_torch.train.losses import resolve_loss

    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, ".bench_cache")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    paths, times = {}, {}
    none = {k: 0 for k in _cuda.launch_counts}

    def add_path(name, *counts):
        total = dict(none)
        for c in counts:
            for k, v in c.items():
                total[k] += v
        paths[name] = total

    # 11(a) bench.py's smooth stage: nside 1024, sigma 10', one map, one
    # channel, the stencil method (m repetitions of a radius-4 template)
    n, sigma = SMOOTH
    npix = 12 * n * n
    t = time.perf_counter()
    if prebuild_s.wait() != 0:
        raise RuntimeError("building the smoothing operator failed")
    with open(os.path.join(cache, "smooth_build.json")) as fh:
        build_s = json.load(fh)
    wait_s = time.perf_counter() - t
    x = torch.from_numpy(rng.normal(size=(1, npix, 1)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(1, npix, 1)).astype(np.float32)).to(dev)
    t = time.perf_counter()
    op = SmoothingOperator(nside=n, indices=np.arange(npix), sigma=sigma,
                           method="stencil", data_path=cache)
    st, m = op.stencil, op.stencil_reps
    if (m, st.radius, len(st.offsets), st.n_steps, op.stencil_apps) != (
            5, 4, 81, 4, 1):
        raise AssertionError(f"the decomposition: m={m}, radius "
                             f"{st.radius}, h={st.n_steps}")
    layer = HealpySmoothing(op)
    with torch.no_grad():
        y, fwd, rt = counted(lambda: layer(x))
    load_s = time.perf_counter() - t
    if (fwd != {**none, "strips": m, "stencil_conv": m}
            or rt["smooth_fused"] != 1):
        raise AssertionError(f"a smoothing forward launched {fwd}, routes "
                             f"{rt}")
    tables = layer._tables(dev)
    ct = {k: v for k, v in tables.items() if k not in ("n2f", "f2n")}
    plane_bytes = tables["weights"].numel() * 4
    xf = x[:, tables["n2f"]]
    wf = w[:, tables["n2f"]]
    # the kernels against the same chain's plain (per-step) version on the
    # same CUDA input, and the layer (NEST) against the chain.  Both
    # gradients are autograd through the per-step chain, so e_g is 0 by
    # construction; the nside-64 check below holds S^T to scipy
    xk = xf.clone().requires_grad_()
    yk = smooth_chain(st, ct, xk, [m], 1)
    (gk,), bwd, _ = counted(lambda: torch.autograd.grad((yk * wf).sum(), xk))
    xp = xf.clone().requires_grad_()
    yp = smooth_chain_plain(st, ct, xp, [m], 1)
    (gp,) = torch.autograd.grad((yp * wf).sum(), xp)
    e_y, e_g = rel_err(yk.detach(), yp.detach()), rel_err(gk, gp)
    e_layer = rel_err(y, yk.detach()[:, tables["f2n"]])
    if bwd != none or not (e_y <= TOL and e_g <= 1e-5 and e_layer <= TOL):
        raise AssertionError(
            f"rel err {e_y:.3e} (layer {e_layer:.3e}), gradient {e_g:.3e}; "
            f"the backward launched {bwd}")
    with torch.no_grad():
        yc = layer(torch.full_like(x, 2.5))
    e_const = (yc - 2.5).abs().max().item() / 2.5
    if not e_const <= 1e-6:
        raise AssertionError(f"a constant map moved by {e_const:.3e}")
    # device times by graph replay: the chain from face-flat maps, the
    # layer from NEST, one pass's K1 alone; the plain chain by events
    with torch.no_grad():
        ms_chain = graph_ms(lambda: smooth_chain(st, ct, xf, [m], 1), iters=5)
        ms_layer = graph_ms(lambda: layer(x), iters=5)
        xc = cface_embed_flat(xf, st)
        wk3 = torch.zeros((2, 1, 1), device=dev)
        wk3[1].fill_(1.0)
        s_ = build_strips(st, xc, tables["strip_idx"])
        ms_k1 = graph_ms(lambda: fs.run_stencil_kernel(
            st, "mono", 2, xc, tables["weights"], s_, wk3, 1))
        ms_plain = cuda_ms(lambda: smooth_chain_plain(st, ct, xf, [m], 1),
                           iters=3, warmup=1)
    k1b = k1_bound(st, 2, 1, 1, 1)
    plan = fs._k1_plan(n, st.n_steps, 4, 81, 2, 1, 12, 1, 1, sms)
    smooth = dict(passes=m, e_y=e_y, e_g=e_g, e_const=e_const,
                  ms_chain=ms_chain, ms_layer=ms_layer, ms_k1=ms_k1,
                  ms_plain=ms_plain, bound=m * k1b[0], by=k1b[1],
                  k1_bound=k1b[0], plane_bytes=plane_bytes, load_s=load_s)
    say("smoothing", f"nside {n}, sigma {sigma}' (h={st.n_steps}): m={m} "
        f"repetitions of a radius-{st.radius} template, {len(st.offsets)} "
        f"taps, {m} passes; tap planes {plane_bytes} bytes on the card "
        f"({plane_bytes / 1e9:.3f} GB); host build {build_s:.2f} s in the "
        f"side process, loaded in {load_s:.2f} s; a forward launched {fwd}, "
        f"its backward {bwd}; rel err vs the plain chain {e_y:.2e} (layer "
        f"{e_layer:.2e}), gradient {e_g:.2e} (the same VJP: 0 by "
        f"construction); constant map {e_const:.2e}; graph replay: chain "
        f"{ms_chain:.4f} ms from face-flat maps (bound {m * k1b[0]:.4f} ms, "
        f"{k1b[1]}), layer {ms_layer:.4f} ms from NEST, one pass's K1 "
        f"{ms_k1:.4f} ms (bound {k1b[0]:.4f} ms; plan {plan}); plain chain "
        f"{ms_plain:.3f} ms (CUDA events) on {card}")
    add_path("smoothing", fwd, bwd)
    del layer, tables, xk, yk, gk, xp, gp, xc, s_
    torch.cuda.empty_cache()
    # the whole chain in one pass (h = 4 m), timed where K1 has a plan
    deep = fs._k1_plan(n, 4 * m, 4, 81, m + 1, 1, 12, 1, 1, sms)
    if deep is None:
        smooth["ms_whole_chain"] = None
        say("smoothing", f"the whole chain in one pass (h={4 * m}): no K1 "
            f"plan on {sms} SMs, not timed")
    else:
        opd = _with_apps(op, m)
        td = HealpySmoothing(opd)._tables(dev)
        ctd = {k: v for k, v in td.items() if k not in ("n2f", "f2n")}
        with torch.no_grad():
            e_deep = rel_err(smooth_chain(opd.stencil, ctd, xf, [m], m),
                             yp.detach())
            ms_deep = graph_ms(lambda: smooth_chain(opd.stencil, ctd, xf,
                                                    [m], m), iters=5)
        if not e_deep <= TOL:
            raise AssertionError(f"the whole chain in one pass: rel err "
                                 f"{e_deep:.3e}")
        smooth["ms_whole_chain"] = ms_deep
        say("smoothing", f"the whole chain in one pass (h={4 * m}, plan "
            f"{deep}): {ms_deep:.4f} ms by graph replay, rel err "
            f"{e_deep:.2e} on {card}")
        del opd, td, ctd
    del yp, op, st, ct
    torch.cuda.empty_cache()
    say("smoothing", f"waited {wait_s:.2f} s for the side process")
    times["smoothing"] = smooth

    # S^m x and the gradient (S^m)^T w at nside 64 (the same sigma /
    # spacing ratio: m = 5 of radius 4) on the card, against m float64
    # matvecs of the template's ELLPACK and of its transpose (scipy)
    n64 = 64
    npix64 = 12 * n64 * n64
    op64 = SmoothingOperator(nside=n64, indices=np.arange(npix64),
                             sigma=sigma * n / n64, method="stencil")
    m64, sig64, r64 = _stencil_decomposition(
        op64.sigma_rad, dt.sphere.healpix.nside2resol(n64), 3)
    if (op64.stencil_reps, op64.stencil.radius, m64, r64) != (5, 4, 5, 4):
        raise AssertionError("the nside-64 operator's decomposition")
    idx, val = _template_ellpack(n64, sig64, r64, 3, op64.indices)
    T = scipy.sparse.csr_matrix(
        (np.asarray(val, np.float64).ravel(),
         (np.repeat(np.arange(npix64), idx.shape[1]), idx.ravel())),
        shape=(npix64, npix64))
    x64 = rng.normal(size=(2, npix64, 1))
    w64 = rng.normal(size=(2, npix64, 1))
    y_ref, g_ref, g_sym = x64[:, :, 0].T, w64[:, :, 0].T, w64[:, :, 0].T
    for _ in range(m64):
        y_ref, g_ref, g_sym = T @ y_ref, T.T @ g_ref, T @ g_sym
    xd = torch.from_numpy(x64).to(dev, torch.float32).requires_grad_()
    yd = HealpySmoothing(op64)(xd)
    (gd,) = torch.autograd.grad(
        (yd * torch.from_numpy(w64).to(dev, torch.float32)).sum(), xd)
    e64 = [rel_err(a[:, :, 0].T.double().cpu(), torch.from_numpy(b))
           for a, b in ((yd.detach(), y_ref), (gd, g_ref))]
    e_sym = rel_err(torch.from_numpy(g_sym), torch.from_numpy(g_ref))
    if not (e64[0] <= 1e-5 and e64[1] <= 1e-5 and e_sym > 1e-3):
        raise AssertionError(f"nside 64 against float64 (scipy): y "
                             f"{e64[0]:.3e}, gradient {e64[1]:.3e}; S^m w "
                             f"differs from (S^m)^T w by {e_sym:.3e}")
    say("smoothing", f"nside {n64}, sigma {sigma * n / n64}' (m=5, radius "
        f"4): the card against float64 scipy matvecs of the template: y "
        f"{e64[0]:.2e}, gradient against (S^m)^T w {e64[1]:.2e} (S^m w, a "
        f"symmetric backward's, is {e_sym:.2e} away)")

    # 11(b) a masked sky (a polar cap) and per-channel repetitions over 3
    # channels, both methods: the card against the CPU
    n = 64
    vec = np.asarray(dt.sphere.healpix.pix2vec(n, np.arange(12 * n * n),
                                                nest=True))
    cap = np.where(vec[:, 2] > 0.2)[0]
    res_am = np.degrees(dt.sphere.healpix.nside2resol(n)) * 60
    xm = rng.normal(size=(2, len(cap), 3)).astype(np.float32)
    masked_counts = []
    for method, sig in (("stencil", [2.0 * res_am, 2.5 * res_am, 3.0 * res_am]),
                        ("ellpack", [1.0 * res_am, 1.3 * res_am, 1.5 * res_am])):
        op = SmoothingOperator(nside=n, indices=cap, sigma=sig, method=method)
        out = []
        for d in (dev, torch.device("cpu")):
            xd = torch.from_numpy(xm).to(d).requires_grad_()
            layer = HealpySmoothing(op)
            yd, c, _ = counted(lambda: layer(xd))
            (gd,) = torch.autograd.grad(torch.sin(yd).sum(), xd)
            out.append((yd.detach().cpu(), gd.cpu(), c))
        errs = [rel_err(a, b) for a, b in zip(out[0][:2], out[1][:2])]
        c = out[0][2]
        reps = op.per_channel_repetitions
        passes = (int(op.stencil_reps * max(reps)) if method == "stencil"
                  else 0)
        if (c != {**none, "strips": passes, "stencil_conv": passes}
                or not max(errs) <= 1e-5):
            raise AssertionError(f"masked {method}: launched {c}, rel err "
                                 f"y {errs[0]:.3e} gradient {errs[1]:.3e}")
        masked_counts.append(c)
        say("smoothing", f"masked {method}, nside {n}, {len(cap)} pixels, "
            f"3 channels (repetitions {[int(r) for r in reps]}"
            + (f" x m={op.stencil_reps}" if method == "stencil" else "")
            + f"): launched {c}; against the CPU: y {errs[0]:.2e}, gradient "
            f"{errs[1]:.2e}")
    add_path("smoothing_masked", *masked_counts)

    # 12. the kitchen-sink network at the reference's nside 256, batch 4
    loss_name = "sparse_categorical_crossentropy_from_logits"
    n = 256
    npix = 12 * n * n
    t = time.perf_counter()
    model = dt.HealpyGCNN(n, np.arange(npix), kitchen_sink_layers(hp_nn))
    model.build((4, npix, 1), seed=71, device=dev)
    plan = [type(l).__name__ for l in model.layers.values()]
    n_cface = sum(1 for l in model.layers.values()
                  if getattr(l, "layout", None) == "cface"
                  and hasattr(l, "graph")
                  for _ in range(2 if type(l).__name__ == "ResidualLayer"
                                 else 1))
    if n_cface != 4:
        raise AssertionError(f"the kitchen sink's plan {plan}")
    xs = rng.normal(size=(16, npix, 1)).astype(np.float32)
    ys = rng.randint(0, 4, size=16)
    logits, srv, srv_rt = counted(lambda: model.predict(xs, batch_size=4))
    if srv != {**none, "strips": 16, "stencil_conv": 16} or any(srv_rt.values()):
        raise AssertionError(f"the kitchen sink served with {srv}, routes "
                             f"{srv_rt}")
    t64 = time.perf_counter()
    cpu64 = nest_reference(dt, model, n, kitchen_sink_layers(hp_nn))
    with torch.no_grad():
        ev64 = cpu64.eval()(torch.from_numpy(xs[:4].astype(np.float64)))
    rel = float((torch.from_numpy(logits[:4]).double() - ev64).abs().max()
                / ev64.abs().max())
    cpu64.train()
    out64 = cpu64(torch.from_numpy(xs[:4].astype(np.float64)))
    loss64 = resolve_loss(loss_name)(torch.from_numpy(ys[:4]), out64)
    loss64.backward()
    g64 = grads_of(cpu64)
    loss64 = float(loss64.detach())
    cpu_s = time.perf_counter() - t64
    del cpu64, out64
    if not (logits.shape == (16, 4) and np.isfinite(logits).all()
            and rel <= 1e-4):
        raise AssertionError(f"the kitchen sink's logits {logits.shape} rel "
                             f"{rel:.3e} from float64")
    want_step = {True: {**none, "strips": 8, "stencil_conv": 4, "dxdw": 4},
                 False: {**none, "strips": 8, "stencil_conv": 8, "grad": 4}}
    steps = {}
    try:
        for fused in (True, False):
            config.set_fused_dw(fused)
            m_ = copy.deepcopy(model)
            m_.compile(optimizer=1e-3, loss=loss_name)
            logs, c, r = counted(
                lambda: m_._trainer.train_on_batch(xs[:4], ys[:4]))
            loss_rel = abs(logs["loss"] - loss64) / abs(loss64)
            # a key projection's bias shifts every logit of a query alike,
            # which the softmax cancels: its gradient is 0 but for
            # rounding, and is held over the tree's largest entry
            g = grads_of(m_)
            g_err = tree_errs(g, g64)
            g_tree = tree_errs(g, g64, scale=tree_max(g64))
            bad = {k: e for k, e in held(g_err, GRAD_TOL).items()
                   if not (k.endswith("wk/bias") and g_tree[k] <= GRAD_TOL)}
            if (c != want_step[fused] or any(r.values())
                    or not loss_rel <= 1e-5 or bad):
                raise AssertionError(
                    f"fused_dw={fused}: a kitchen-sink step launched {c} "
                    f"(routes {r}), loss rel {loss_rel:.3e}, gradients "
                    f"above the limit {bad}")
            steps[fused] = (m_, c, loss_rel, max(g_tree.values()),
                            max(e for k, e in g_err.items()
                                if not k.endswith("wk/bias")))
    finally:
        config.set_fused_dw(True)
    add_path("kitchen_sink", srv, steps[True][1], steps[False][1])
    ks_ms, _ = time_routes(config, {f: steps[f][0]._trainer for f in steps},
                           xs, ys, steps=6, warmup=2, batch=4)
    tr = steps[True][0]._trainer
    ks_ops, ks_busy, ks_top, _ = device_profile(
        lambda i: tr.train_on_batch(xs[4 * i:4 * i + 4], ys[4 * i:4 * i + 4]),
        3, top=6)
    xb = torch.from_numpy(xs[:4]).to(dev)
    model.eval()
    with torch.inference_mode():
        ks_fwd = cuda_ms(lambda: model(xb), iters=10, warmup=2)
    say("kitchen sink", f"nside {n}, batch 4 ({time.perf_counter() - t:.2f} "
        f"s with the float64 CPU step, {cpu_s:.1f} s of it): plan {plan}; 4 "
        f"requests launched {srv}, logits rel {rel:.2e} from float64; "
        f"{ks_fwd:.3f} ms per forward of 4 maps; train step K2 route "
        f"{ks_ms[True]:.3f} ms (launches {steps[True][1]}, loss rel "
        f"{steps[True][2]:.2e}, gradients {steps[True][4]:.2e} of each "
        f"leaf's max, {steps[True][3]:.2e} of the tree's), K1+K3 route "
        f"{ks_ms[False]:.3f} ms (launches {steps[False][1]}, loss rel "
        f"{steps[False][2]:.2e}, gradients {steps[False][4]:.2e} / "
        f"{steps[False][3]:.2e}); profile of the K2-route step: "
        f"{ks_ops:.0f} device ops, {ks_busy:.3f} ms device-busy = "
        f"{ks_busy / ks_ms[True]:.1%} of the step; top: "
        + "; ".join(f"{nm[:50]} x{c:.0f} {t_:.3f} ms" for nm, c, t_ in ks_top)
        + f" on {card}")
    times["kitchen_sink"] = {"fwd_ms": ks_fwd, "step_ms": ks_ms,
                             "device_ops": ks_ops, "busy_ms": ks_busy}
    del model, steps, tr
    torch.cuda.empty_cache()
    return paths, times


def cface_embed_flat(xf, st):
    """(B, npix, C) face-flat -> (B*C, 12, n, P_l), the fused conv's
    input."""
    from deepsphere_tpu_torch.ops.stencil import cface_embed

    B, _, C = xf.shape
    return cface_embed(xf, st.nside, st.n_steps).reshape(
        B * C, 12, st.nside, -1).contiguous()


def chain_and_family(dev, card, rng, prebuild):
    """Phases 9 and 10: the lap chain (a k=40 conv in NEST, and fault 3.2's
    shape inside a classifier) and the conv family at full width (the
    autoencoder, the residual stack, Bernstein).  Returns the launches of
    each main path, the chain's times and the family's."""
    import deepsphere_tpu_torch as dt
    from deepsphere_tpu_torch import config
    from deepsphere_tpu_torch.graph import build_sphere_graph
    from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
    from deepsphere_tpu_torch.ops import _cuda
    from deepsphere_tpu_torch.ops import fused_stencil as fs
    from deepsphere_tpu_torch.ops import stencil as tst
    from deepsphere_tpu_torch.ops.layout import face_to_nest, nest_to_face
    from deepsphere_tpu_torch.ops.stencil import (
        as_tensors,
        cface_embed,
        cface_extract,
        stencil_graph_conv,
        stencil_tables,
    )
    from deepsphere_tpu_torch.ops.strips import build_strips
    from deepsphere_tpu_torch.train.losses import resolve_loss

    loss_name = "sparse_categorical_crossentropy_from_logits"
    # 9. the lap chain: one L~ application per launch (K4 strips, then K1
    # with the term selector kernel) on the shallow stencil, h = radius
    path_launches = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def add_path(name, *counts):
        total = {k: 0 for k in _cuda.launch_counts}
        for c in counts:
            for k, v in c.items():
                total[k] += v
        path_launches[name] = total

    # (a) a k=40 grid graph (radius 3) at nside 256, Chebyshev K=5, 4 -> 4,
    # batch 4, NEST layout: bench.py's k20 stage moved to k=40
    n, k40, K = K40_GRAPH
    B, Fin, Fout = 4, 4, 4
    M = 12 * n * n
    t = time.perf_counter()
    if prebuild.wait() != 0:
        raise RuntimeError("building the k=40 graph failed")
    root = os.path.dirname(os.path.abspath(__file__))
    g40 = build_sphere_graph(n, k=k40, method="grid",
                             cache_dir=os.path.join(root, ".bench_cache"))
    st40 = g40.face_stencil(0.75)
    st40d = g40.deep_stencil(0.75, K)
    g40_s = time.perf_counter() - t
    tab40 = as_tensors(stencil_tables(st40), dev)
    if (st40.radius, st40.n_steps) != (3, 3) or tst.conv_route(
            st40, "cheby", K, True) != "chain":
        raise AssertionError("the k=40 conv does not take the lap chain")
    x40 = torch.from_numpy(rng.normal(size=(B, M, Fin)).astype(np.float32)).to(dev)
    k40 = torch.from_numpy((rng.normal(size=(Fin * K, Fout))
                            / np.sqrt(Fin * K)).astype(np.float32)).to(dev)
    cot40 = torch.from_numpy(rng.normal(size=(B, M, Fout)).astype(np.float32)).to(dev)
    chain = lambda a, w, layout="nest": stencil_graph_conv(
        st40, a, w, K, "cheby", tables=tab40, layout=layout)
    plain = lambda a, w: tst._per_step(st40, a, w, K, "cheby", tab40, "nest")
    with torch.no_grad():
        y_c, fwd40, rt40 = counted(lambda: chain(x40, k40))
        y_p = plain(x40, k40)
    e40 = rel_err(y_c, y_p)
    if fwd40 != chain_launches(K - 1) or rt40["lap_chain"] != 1:
        raise AssertionError(f"k=40 chain forward launched {fwd40}, routes "
                             f"{rt40}")
    if not e40 <= TOL:
        raise AssertionError(f"k=40 chain rel err {e40:.3e} vs per step")
    xl = x40.clone().requires_grad_()
    kl = k40.clone().requires_grad_()
    dx_p, dk_p = torch.autograd.grad(plain(xl, kl), (xl, kl), cot40)
    bwd40 = {}
    try:
        for fused_dw in (True, False):
            config.set_fused_dw(fused_dw)
            (dx_c, dk_c), c, _ = counted(lambda: torch.autograd.grad(
                chain(xl, kl), (xl, kl), cot40))
            e_dx, e_dk = rel_err(dx_c, dx_p), rel_err(dk_c, dk_p)
            if c != chain_launches(K - 1, fused_dw) or not (
                    e_dx <= TOL and e_dk <= DW_TOL):
                raise AssertionError(
                    f"k=40 chain fwd + bwd fused_dw={fused_dw}: launched {c}"
                    f", dx rel {e_dx:.3e}, dW rel {e_dk:.3e}")
            ms = cuda_ms(lambda: torch.autograd.grad(chain(xl, kl), (xl, kl),
                                                     cot40), iters=5, warmup=1)
            bwd40[fused_dw] = (c, e_dx, e_dk, ms)
    finally:
        config.set_fused_dw(True)
    add_path("lap_chain", fwd40, bwd40[True][0], bwd40[False][0])
    del dx_p, dk_p, xl, kl
    # device times by graph replay: the whole chain from face-flat maps,
    # one lap's K1, and the one-shot conv on the deep stencil (h=12) where
    # K1 has a plan for it
    xf40 = nest_to_face(x40)
    ms_chain = graph_ms(lambda: chain(xf40, k40, "face"), iters=5)
    ms_chain_nest = graph_ms(lambda: chain(x40, k40), iters=5)
    ms_plain40 = cuda_ms(lambda: plain(x40, k40), iters=3, warmup=1)
    sel = torch.stack([torch.zeros(Fin, Fin, device=dev),
                       torch.eye(Fin, device=dev)], dim=1).reshape(2 * Fin,
                                                                   Fin)
    xc40 = cface_embed(xf40, n, 3).reshape(B * Fin, 12, n, -1).contiguous()
    lap_args = (st40, "mono", 2, xc40, tab40["weights"],
                build_strips(st40, xc40, tab40["strip_idx"]),
                fs._wk3(sel, 2), B)
    ms_lap_k1 = graph_ms(lambda: fs.run_stencil_kernel(*lap_args))
    lap_bound = k1_bound(st40, 2, B, Fin, Fin)
    lap_plan = fs._k1_plan(n, 3, 3, len(st40.offsets), 2, B, 12, Fin, Fin,
                           sms)
    hd = st40d.n_steps
    one_plan = fs._k1_plan(n, hd, 3, len(st40d.offsets), K, B, 12, Fin, Fout,
                           sms)
    one = "no K1 plan"
    if one_plan is not None:
        tab40d = as_tensors(stencil_tables(st40d), dev)
        xc40d = cface_embed(xf40, n, hd).reshape(B * Fin, 12, n, -1).contiguous()
        one_shot = lambda: fs.fused_stencil_conv_cfp(st40d, tab40d, xc40d, k40,
                                                     K, "cheby", B)
        with torch.no_grad():
            y1 = cface_extract(one_shot().reshape(B, Fout, 12, n, -1), hd)
        e1 = rel_err(face_to_nest(y1), y_p)
        if not e1 <= TOL:
            raise AssertionError(f"k=40 one-shot conv rel err {e1:.3e}")
        ms_one = graph_ms(one_shot, iters=5)
        s40d = build_strips(st40d, xc40d, tab40d["strip_idx"])
        ms_one_k1 = graph_ms(lambda: fs.run_stencil_kernel(
            st40d, "cheby", K, xc40d, tab40d["weights"], s40d,
            fs._wk3(k40, K), B))
        one_bound = k1_bound(st40d, K, B, Fin, Fout)
        one = (f"one-shot conv (h={hd}, plan {one_plan}, rel {e1:.2e}) "
               f"{ms_one:.4f} ms, its K1 alone {ms_one_k1:.4f} ms (bound "
               f"{one_bound[0]:.4f} ms, {one_bound[1]})")
        del tab40d, xc40d, s40d
    say("lap chain", f"k=40 grid graph nside {n} (waited for and loaded "
        f"the graph and stencils in {g40_s:.2f} s), Chebyshev K={K}, B={B}, {Fin} -> {Fout}, NEST: "
        f"route chain, a forward launched {fwd40}; rel err vs the per-step "
        f"path {e40:.2e}; fwd + bwd K2 route {bwd40[True][3]:.3f} ms "
        f"(dx {bwd40[True][1]:.2e}, dW {bwd40[True][2]:.2e}, launches "
        f"{bwd40[True][0]}), K1+K3 route {bwd40[False][3]:.3f} ms (dx "
        f"{bwd40[False][1]:.2e}, dW {bwd40[False][2]:.2e}, launches "
        f"{bwd40[False][0]}); graph replay: chain {ms_chain:.4f} ms from "
        f"face-flat maps ({ms_chain_nest:.4f} from NEST), one lap's K1 "
        f"{ms_lap_k1:.4f} ms (bound {lap_bound[0]:.4f} ms, {lap_bound[1]}; "
        f"plan {lap_plan}); {one}; per-step plain {ms_plain40:.3f} ms "
        f"(CUDA events) on {card}")
    chain_times = {"chain_ms": ms_chain, "chain_nest_ms": ms_chain_nest,
                   "lap_k1_ms": ms_lap_k1, "plain_ms": ms_plain40,
                   "one_shot": one}
    del tab40, x40, xf40, xc40, cot40, lap_args, y_c, y_p

    # (b) ROADMAP fault 3.2 inside a model: a classifier on the k=20 graph
    # at nside 64, batch 16, Chebyshev K=11 (h=20) 1 -> 8 and 8 -> 16: no
    # one-shot K2 takes conv 2, so it trains on the chain
    nside = 64
    npix = 12 * nside * nside
    t = time.perf_counter()
    model = dt.HealpyGCNN(nside, np.arange(npix), [
        hp_nn.HealpyChebyshev(K=11, Fout=8, activation="relu"),
        hp_nn.HealpyChebyshev(K=11, Fout=16, activation="relu"),
        hp_nn.HealpyPool(p=1), hp_nn.Flatten(), hp_nn.Dense(4)],
        n_neighbors=20)
    model.build((16, npix, 1), seed=31)
    convs = [m for m in model.layers.values()
             if getattr(m, "layout", None) == "cface" and hasattr(m, "graph")]
    rts = [fs.cface_route(c._stencil(), "cheby", 11, 16, fi, fo, sms)
           for c, (fi, fo) in zip(convs, ((1, 8), (8, 16)))]
    if rts != ["fused", "chain"]:
        raise AssertionError(f"the k=20 convs took the routes {rts}")
    x9 = rng.normal(size=(16, npix, 1)).astype(np.float32)
    y9 = rng.randint(0, 4, size=16)
    # serving needs no gradient, and K1 alone takes conv 2 one shot
    logits, srv9, srv_rt9 = counted(lambda: model.predict(x9, batch_size=16))
    if (srv9 != {"strips": 2, "stencil_conv": 2, "dxdw": 0, "grad": 0,
                 "bands": 0} or any(srv_rt9.values())):
        raise AssertionError(f"the k=20 model served with {srv9}, routes "
                             f"{srv_rt9}")
    # a training forward: conv 2 on the chain (10 laps), conv 1 one shot
    xb = torch.from_numpy(x9).to(dev)
    model.train()
    _, fwd9, rt9 = counted(lambda: model(xb))
    model.eval()
    want9 = {"strips": 11, "stencil_conv": 11, "dxdw": 0, "grad": 0,
             "bands": 0}
    if fwd9 != want9 or rt9["chain_cface"] != 1:
        raise AssertionError(f"the k=20 model's training forward launched "
                             f"{fwd9}, routes {rt9}")
    t64 = time.perf_counter()
    cpu64 = nest_reference(dt, model, nside, [
        hp_nn.HealpyChebyshev(K=11, Fout=8, activation="relu"),
        hp_nn.HealpyChebyshev(K=11, Fout=16, activation="relu"),
        hp_nn.HealpyPool(p=1), hp_nn.Flatten(), hp_nn.Dense(4)],
        n_neighbors=20)
    cpu64.train()
    out64 = cpu64(torch.from_numpy(x9.astype(np.float64)))
    loss64 = resolve_loss(loss_name)(torch.from_numpy(y9), out64)
    loss64.backward()
    g64 = grads_of(cpu64)
    out64 = out64.detach().numpy()
    loss64 = float(loss64.detach())
    cpu_s = time.perf_counter() - t64
    del cpu64
    rel = float(np.abs(logits - out64).max() / np.abs(out64).max())
    if not (logits.shape == (16, 4) and rel <= 1e-4):
        raise AssertionError(f"the k=20 model's logits {logits.shape} rel "
                             f"{rel:.3e} from float64")
    steps9 = {}
    try:
        for fused in (True, False):
            config.set_fused_dw(fused)
            m = copy.deepcopy(model)
            m.compile(optimizer=1e-3, loss=loss_name)
            logs, c, r = counted(lambda: m._trainer.train_on_batch(x9, y9))
            kern = "dxdw" if fused else "grad"
            if (r["chain_cface"] != 1 or c["strips"] == 0
                    or c["stencil_conv"] == 0 or c[kern] == 0):
                raise AssertionError(f"fused_dw={fused}: the k=20 train "
                                     f"step launched {c}, routes {r}")
            loss_rel = abs(logs["loss"] - loss64) / abs(loss64)
            g_err = tree_errs(grads_of(m), g64)
            if not loss_rel <= 1e-5 or held(g_err, GRAD_TOL):
                raise AssertionError(
                    f"fused_dw={fused}: the k=20 train step's loss rel "
                    f"{loss_rel:.3e}, gradients {g_err} from float64")
            steps9[fused] = (c, loss_rel, max(g_err.values()))
            del m
    finally:
        config.set_fused_dw(True)
    add_path("chain_cface", fwd9, steps9[True][0], steps9[False][0])
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(xb), iters=5, warmup=1)
    say("lap chain", f"k=20 classifier nside {nside}, batch 16, Chebyshev "
        f"K=11 (h={convs[0]._stencil().n_steps}) 1 -> 8 -> 16 "
        f"({time.perf_counter() - t:.2f} s with the float64 CPU step, "
        f"{cpu_s:.1f} s of it): routes {rts} in training; serving 16 maps "
        f"launched {srv9}, logits rel {rel:.2e} from float64; a training "
        f"forward launched {fwd9} (routes {rt9}); train step K2 "
        f"route launched {steps9[True][0]}, loss rel {steps9[True][1]:.2e}, "
        f"gradients {steps9[True][2]:.2e}; K1+K3 route launched "
        f"{steps9[False][0]}, loss rel {steps9[False][1]:.2e}, gradients "
        f"{steps9[False][2]:.2e}; {fwd_ms:.3f} ms per serving forward of 16 "
        f"maps on {card}")
    del model

    # 10. the conv family at full width
    # (a) the autoencoder of examples/autoencoder.py: nside 64, bottleneck
    # 16, its published widths, one cface segment from input to output
    nside, bott = 64, 16
    npix = 12 * nside * nside
    t = time.perf_counter()
    model = dt.HealpyGCNN(nside, np.arange(npix),
                          autoencoder_layers(hp_nn, nside, bott))
    model.build((8, npix, 1), seed=41)
    plan = [type(m).__name__ for m in model.layers.values()]
    mids = list(model.layers.values())[1:-1]
    if (plan.count("NestToCface") != 1 or plan.count("CfaceToNest") != 1
            or any(getattr(m, "layout", None) != "cface" for m in mids)):
        raise AssertionError(f"the autoencoder's plan {plan}")
    init = copy.deepcopy(model)
    xa = rng.normal(size=(32, npix, 1)).astype(np.float32)
    rec, fwd_a, rt_a = counted(lambda: model.predict(xa, batch_size=8))
    want_a = {"strips": 20, "stencil_conv": 20, "dxdw": 0, "grad": 0,
              "bands": 0}  # 5 convs x 4 requests
    if fwd_a != want_a or any(rt_a.values()):
        raise AssertionError(f"the autoencoder served with {fwd_a}, routes "
                             f"{rt_a}")
    cpu64 = nest_reference(dt, model, nside,
                           autoencoder_layers(hp_nn, nside, bott))
    out64 = cpu64(torch.from_numpy(xa[:8].astype(np.float64)))
    loss64 = resolve_loss("mse")(torch.from_numpy(xa[:8].astype(np.float64)),
                                 out64)
    loss64.backward()
    g64 = grads_of(cpu64)
    rel = float(np.abs(rec[:8] - out64.detach().numpy()).max()
                / np.abs(out64.detach().numpy()).max())
    loss64 = float(loss64.detach())
    del cpu64, out64
    if not (rec.shape == xa.shape and np.all(np.isfinite(rec))
            and rel <= 1e-4):
        raise AssertionError(f"the autoencoder's output {rec.shape} rel "
                             f"{rel:.3e} from float64")
    want_step = {True: {"strips": 10, "stencil_conv": 5, "dxdw": 5, "grad": 0,
                        "bands": 0},
                 False: {"strips": 9, "stencil_conv": 9, "dxdw": 0, "grad": 5,
                         "bands": 0}}
    ae = {}
    try:
        for fused in (True, False):
            config.set_fused_dw(fused)
            m = copy.deepcopy(init)
            m.compile(optimizer=1e-3, loss="mse")
            logs, c, r = counted(
                lambda: m._trainer.train_on_batch(xa[:8], xa[:8]))
            loss_rel = abs(logs["loss"] - loss64) / abs(loss64)
            g_err = tree_errs(grads_of(m), g64)
            logs2 = m._trainer.train_on_batch(xa[8:16], xa[8:16])
            if (c != want_step[fused] or any(r.values())
                    or not loss_rel <= 1e-5 or held(g_err, GRAD_TOL)
                    or not np.isfinite(logs2["loss"])):
                raise AssertionError(
                    f"fused_dw={fused}: an autoencoder step launched {c} "
                    f"(routes {r}), loss rel {loss_rel:.3e}, gradients "
                    f"{g_err}, second loss {logs2['loss']}")
            ae[fused] = (m, c, loss_rel, max(g_err.values()), logs2["loss"])
    finally:
        config.set_fused_dw(True)
    add_path("autoencoder", fwd_a, ae[True][1], ae[False][1])
    ae_ms, _ = time_routes(config, {f: ae[f][0]._trainer for f in ae}, xa, xa,
                           steps=6, warmup=2, batch=8)
    tr = ae[True][0]._trainer
    ae_ops, ae_busy, ae_top, _ = device_profile(
        lambda i: tr.train_on_batch(xa[8 * i:8 * i + 8], xa[8 * i:8 * i + 8]),
        3, top=4)
    xb = torch.from_numpy(xa[:8]).to(dev)
    model.eval()
    with torch.inference_mode():
        ae_fwd = cuda_ms(lambda: model(xb), iters=10, warmup=2)
    say("family", f"autoencoder nside {nside} -> {bott} -> {nside}, batch 8 "
        f"({time.perf_counter() - t:.2f} s with the float64 CPU step): plan "
        f"{plan}; 4 requests launched {fwd_a}, output rel {rel:.2e} from "
        f"float64; {ae_fwd:.3f} ms per forward of 8 maps; train step K2 "
        f"route {ae_ms[True]:.3f} ms (launches {ae[True][1]}, loss rel "
        f"{ae[True][2]:.2e}, gradients {ae[True][3]:.2e}), K1+K3 route "
        f"{ae_ms[False]:.3f} ms (launches {ae[False][1]}, loss rel "
        f"{ae[False][2]:.2e}, gradients {ae[False][3]:.2e}); second losses "
        f"{ae[True][4]:.6f} / {ae[False][4]:.6f}; profile of the K2-route "
        f"step: {ae_ops:.0f} device ops, {ae_busy:.3f} ms device-busy = "
        f"{ae_busy / ae_ms[True]:.1%} of the step; top: "
        + "; ".join(f"{nm[:50]} x{c:.0f} {t_:.3f} ms" for nm, c, t_ in ae_top)
        + f" on {card}")
    family = {"ae_fwd_ms": ae_fwd, "ae_step_ms": ae_ms, "ae_ops": ae_ops,
              "ae_busy_ms": ae_busy}
    del model, init, ae, tr

    # (b) examples/advanced_masked.py's stack on the full sphere (nside 64,
    # batch 16): the residual layer runs in the cface segment
    nside = 64
    npix = 12 * nside * nside
    xm = rng.normal(size=(16, npix, 1)).astype(np.float32)
    ym = rng.randint(0, 2, size=16)
    masked_launch = []
    for norm in ("batch_norm", "layer_norm"):
        t = time.perf_counter()
        model = dt.HealpyGCNN(nside, np.arange(npix),
                              masked_layers(hp_nn, norm))
        model.build((16, npix, 1), seed=51)
        res = model.layers["layer_2"]
        if res.layout != "cface":
            raise AssertionError(f"the residual layer planned {res.layout}")
        out, fwd_m, rt_m = counted(lambda: model.predict(xm, batch_size=16))
        want_m = {"strips": 4, "stencil_conv": 4, "dxdw": 0, "grad": 0,
                  "bands": 0}
        if fwd_m != want_m or any(rt_m.values()):
            raise AssertionError(f"{norm}: a forward launched {fwd_m}, "
                                 f"routes {rt_m}")
        cpu64 = nest_reference(dt, model, nside, masked_layers(hp_nn, norm))
        with torch.no_grad():
            ev64 = cpu64.eval()(torch.from_numpy(xm.astype(np.float64)))
        rel = float((torch.from_numpy(out).double() - ev64).abs().max()
                    / ev64.abs().max())
        cpu64.train()
        out64 = cpu64(torch.from_numpy(xm.astype(np.float64)))
        loss64 = resolve_loss(loss_name)(torch.from_numpy(ym), out64)
        loss64.backward()
        g64, s64 = grads_of(cpu64), stats_of(cpu64)
        loss64 = float(loss64.detach())
        del cpu64, out64
        model.compile(optimizer=1e-3, loss=loss_name)
        logs, c, r = counted(lambda: model._trainer.train_on_batch(xm, ym))
        # every conv here is normalised, so several leaves are
        # cancellations: a normalised conv's kernel gradient is orthogonal
        # to the kernel, bn1's bias shifts a conv's input whose output bn2
        # centres again, and bn2's running mean is the mean of a centred
        # activation (~1e-4).  float32 resolves those only to ~3e-3 of
        # their own max, so the gradients are held to float64 over the
        # tree's largest entry and the statistics absolutely; each leaf's
        # own error is printed
        loss_rel = abs(logs["loss"] - loss64) / abs(loss64)
        g_err = tree_errs(grads_of(model), g64)
        g_tree = tree_errs(grads_of(model), g64, scale=tree_max(g64))
        s_abs = tree_errs(stats_of(model), s64, scale=1.0)
        bad = {**held(g_tree, GRAD_TOL), **held(s_abs, BN_TOL)}
        if (not rel <= 1e-4 or not loss_rel <= 1e-5 or bad
                or c["dxdw"] != 4 or any(r.values())):
            raise AssertionError(
                f"{norm}: logits rel {rel:.3e}, loss rel {loss_rel:.3e}, "
                f"launches {c}, routes {r}, errors above the limits {bad}")
        masked_launch += [fwd_m, c]
        say("family", f"advanced_masked stack, full sphere nside {nside}, "
            f"batch 16, residual {norm} in cface "
            f"({time.perf_counter() - t:.2f} s with the float64 CPU step): a "
            f"forward launched {fwd_m}, logits rel {rel:.2e}; a train step "
            f"launched {c}, loss rel {loss_rel:.2e}; against float64: "
            f"gradients {max(g_tree.values()):.2e} of the tree's largest "
            f"(per leaf of its own {g_err}), BN statistics "
            f"{max(s_abs.values()):.2e} absolute")
        del model
    add_path("residual", *masked_launch)

    # (c) a Bernstein conv, with and without the reference quirk: the face
    # layout's per-step path, as in the JAX package (no kernel)
    nside = 32
    npix = 12 * nside * nside
    xbn = rng.normal(size=(4, npix, 1)).astype(np.float32)
    ybn = rng.randint(0, 4, size=4)
    for quirk in (False, True):
        model = dt.HealpyGCNN(nside, np.arange(npix), [
            hp_nn.HealpyBernstein(K=3, Fout=8, activation="relu",
                                  ref_quirks=quirk),
            hp_nn.HealpyPool(p=1), hp_nn.Flatten(), hp_nn.Dense(4)])
        model.build((4, npix, 1), seed=61)
        cpu = copy.deepcopy(model).to("cpu")
        out, fwd_b, rt_b = counted(lambda: model.predict(xbn, batch_size=4))
        rel = float(np.abs(out - cpu.predict(xbn, batch_size=4)).max()
                    / np.abs(out).max())
        for m in (model, cpu):
            m.compile(optimizer=1e-3, loss=loss_name)
        logs, c, r = counted(lambda: model._trainer.train_on_batch(xbn, ybn))
        logs_c = cpu._trainer.train_on_batch(xbn, ybn)
        loss_rel = abs(logs["loss"] - logs_c["loss"]) / abs(logs_c["loss"])
        g_err = tree_errs(grads_of(model), grads_of(cpu))
        if (any(fwd_b.values()) or any(c.values()) or any(rt_b.values())
                or not rel <= 1e-4 or not loss_rel <= 1e-5
                or held(g_err, 1e-4)):
            raise AssertionError(
                f"Bernstein ref_quirks={quirk}: launches {fwd_b} / {c}, "
                f"logits rel {rel:.3e}, loss rel {loss_rel:.3e}, gradients "
                f"{g_err}")
        say("family", f"Bernstein K=3 ref_quirks={quirk}, nside {nside}, "
            f"batch 4, layout {model.layers['layer_0'].layout}: no kernel "
            f"launched; logits rel {rel:.2e}, loss rel {loss_rel:.2e}, "
            f"gradients {max(g_err.values()):.2e} from the CPU")
        del model, cpu
    return path_launches, chain_times, family


def serving_model(dt, hp_nn):
    """Phase 4's model: the quick_start classifier at nside 64, full width,
    built on the card from seed 7, with random BN statistics (seed 8)."""
    nside = 64
    model = dt.HealpyGCNN(nside=nside, indices=np.arange(12 * nside * nside),
                          layers=quick_start_layers(hp_nn))
    model.build((16, 12 * nside * nside, 1), seed=7)  # on the card
    bn_rng = np.random.RandomState(8)
    for layer in model.layers.values():
        if getattr(layer, "bn", None) is not None:
            F = layer.bn.mean.shape[0]
            layer.bn.mean.copy_(torch.from_numpy(
                bn_rng.normal(scale=0.1, size=F).astype(np.float32)))
            layer.bn.var.copy_(torch.from_numpy(
                bn_rng.uniform(0.5, 2.0, size=F).astype(np.float32)))
    return model


def replay(artifact, x_path, out_dir, *batches):
    """``--replay ARTIFACT X.npy OUT_DIR B... [MODE]``: phase 13's (and
    15(c)'s, under ``config.conv_dtype`` MODE) serving process.  Loads the artifact through ``serve.load_exported`` with every
    graph builder and stencil extraction patched to raise, answers one
    request of each batch B from the maps in X.npy (in order), writes each
    answer to OUT_DIR/y<i>.npy, times a forward of the first batch with
    CUDA events after a warm-up, and prints one JSON line: the graph's op
    counts, the input shape, each request's launches, the ms."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deepsphere_tpu_torch.graph as g
    import deepsphere_tpu_torch.graph.laplacian as lap
    import deepsphere_tpu_torch.graph.stencil as gst
    from deepsphere_tpu_torch import serve
    from deepsphere_tpu_torch.ops import _cuda

    def refuse(*a, **k):
        raise AssertionError("the serving process built a graph")

    for mod in (g, lap):
        mod.build_sphere_graph = refuse
    gst.face_stencil = refuse
    lap.SphereGraph.face_stencil = refuse
    lap.SphereGraph.deep_stencil = refuse
    from deepsphere_tpu_torch import config

    if batches and not batches[-1].isdigit():  # the conv_dtype it runs under
        config.set_conv_dtype(batches[-1])
        batches = batches[:-1]
    t = time.perf_counter()
    em = serve.load_exported(artifact)
    load_s = time.perf_counter() - t
    x = np.load(x_path)
    out = {"op_counts": em.op_counts(),
           "input_shape": [str(d) for d in em.input_shape],
           "device": str(em.device), "load_s": load_s, "launches": [],
           "bf16_launches": []}
    start = 0
    for i, b in enumerate(int(b) for b in batches):
        _cuda.reset_launch_counts()
        y = em(x[start:start + b])
        torch.cuda.synchronize()
        out["launches"].append(dict(_cuda.launch_counts))
        out["bf16_launches"].append(dict(_cuda.bf16_launch_counts))
        np.save(os.path.join(out_dir, f"y{i}.npy"), y.cpu().numpy())
        start += b
    xb = torch.from_numpy(x[:int(batches[0])]).cuda()
    out["fwd_ms"] = cuda_ms(lambda: em(xb), iters=20, warmup=3)
    print(json.dumps(out), flush=True)


def export_phase(dt, hp_nn, rng, card, serve_ms, ae_fwd_ms):
    """13. Export and serve: the quick_start classifier (phase 4's model)
    and the autoencoder of phase 10(a), each exported on the card with a
    polymorphic batch, saved, and replayed in a fresh process
    (:func:`replay`).  Returns the replays' launches, summed."""
    import shutil
    import tempfile

    here = os.path.abspath(__file__)
    total = {"strips": 0, "stencil_conv": 0, "dxdw": 0, "grad": 0,
             "bands": 0}
    times = {}
    tmp = tempfile.mkdtemp(prefix="ds_export_")
    try:
        nside = 64
        npix = 12 * nside * nside
        cases = [
            ("quick_start", lambda: serving_model(dt, hp_nn), (16, 5),
             serve_ms),
            ("autoencoder", lambda: dt.HealpyGCNN(
                nside, np.arange(npix),
                autoencoder_layers(hp_nn, nside, 16)).build(
                    (8, npix, 1), seed=41), (8, 3), ae_fwd_ms),
        ]
        for name, make, batches, eager_ms in cases:
            t = time.perf_counter()
            model = make()
            n_cf = sum(getattr(m, "layout", None) == "cface"
                       and hasattr(m, "graph") for m in model.layers.values())
            x = rng.normal(size=(sum(batches), npix, 1)).astype(np.float32)
            live, start = [], 0
            for b in batches:  # the live model on the card, one request each
                live.append(model.predict(x[start:start + b], batch_size=b))
                start += b
            xb = torch.from_numpy(x[:batches[0]]).cuda()
            model.eval()
            with torch.inference_mode():
                live_ms = cuda_ms(lambda: model(xb), iters=20, warmup=3)
            path = os.path.join(tmp, f"{name}.pt2")
            t_exp = time.perf_counter()
            nbytes = model.save_exported(path)
            export_s = time.perf_counter() - t_exp
            del model
            torch.cuda.empty_cache()
            x_path = os.path.join(tmp, f"{name}_x.npy")
            np.save(x_path, x)
            t_rep = time.perf_counter()
            res = subprocess.run(
                [sys.executable, here, "--replay", path, x_path, tmp,
                 *map(str, batches)],
                capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"{name}: the replay failed:\n"
                                     f"{res.stdout[-3000:]}\n"
                                     f"{res.stderr[-6000:]}")
            rep = json.loads(res.stdout.strip().splitlines()[-1])
            replay_s = time.perf_counter() - t_rep
            want = {"strips": n_cf, "stencil_conv": n_cf, "dxdw": 0,
                    "grad": 0, "bands": 0}
            errs = []
            for i, y_live in enumerate(live):
                y = np.load(os.path.join(tmp, f"y{i}.npy"))
                errs.append(float(np.abs(y - y_live).max()
                                  / np.abs(y_live).max()))
            if (n_cf < 3 or rep["op_counts"] != {"strips": n_cf,
                                                 "stencil_conv": n_cf}
                    or rep["launches"] != [want] * len(batches)
                    or rep["input_shape"] != ["b", str(npix), "1"]
                    or not max(errs) <= 1e-5):
                raise AssertionError(
                    f"{name}: replay {rep}, logits rel {errs} (tol 1e-5), "
                    f"{n_cf} cface convs")
            for k in total:
                total[k] += sum(c[k] for c in rep["launches"])
            times[name] = {"replay_fwd_ms": rep["fwd_ms"],
                           "live_fwd_ms": live_ms, "bytes": nbytes}
            say("export", f"{name}: {n_cf} cface convs; exported on the card "
                f"in {export_s:.2f} s, {nbytes} bytes; a fresh process "
                f"({replay_s:.1f} s, load {rep['load_s']:.2f} s, no graph "
                f"build) answered {' and '.join(map(str, batches))} maps: "
                f"graph ops {rep['op_counts']}, launches a request "
                f"{rep['launches'][0]}, logits rel {max(errs):.2e} from the "
                f"live model; {rep['fwd_ms']:.3f} ms per replayed forward of "
                f"{batches[0]} maps, {live_ms:.3f} eager here, "
                f"{eager_ms:.3f} in phase {4 if name == 'quick_start' else '10(a)'}"
                f" ({time.perf_counter() - t:.1f} s) on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total, times


def dispatch_cost(dt, hp_nn, card):
    """13(b). The host cost of the kernels' custom-op dispatch, in one
    process (the host drifts between processes): host µs per eager call of
    K4 at quick_start conv 3's shape through its op and through its CUDA
    implementation called directly (``CustomOpDef._init_fn``), 5 rounds of
    2,000 calls in turns; and the quick_start train step (K2 route) with
    the wrappers calling the ops and calling the implementations directly,
    12 rounds in turns (median ms each)."""
    import contextlib
    from types import SimpleNamespace

    from deepsphere_tpu_torch.graph import build_sphere_graph
    from deepsphere_tpu_torch.ops import fused_stencil as fs
    from deepsphere_tpu_torch.ops import library
    from deepsphere_tpu_torch.ops.stencil import as_tensors, stencil_tables

    ops = torch.ops.deepsphere
    direct = SimpleNamespace(**{
        nm: getattr(library, nm)._init_fn
        for nm in ("strips", "stencil_conv", "stencil_dxdw", "stencil_grad",
                   "bands")})

    @contextlib.contextmanager
    def calling(namespace):
        torch.ops.__dict__["deepsphere"] = namespace
        try:
            yield
        finally:
            torch.ops.__dict__["deepsphere"] = ops

    def host_us(fn, n=2000):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        el = time.perf_counter() - t
        torch.cuda.synchronize()
        return el / n * 1e6

    st = build_sphere_graph(16, k=8, method="grid").deep_stencil(0.75, 10)
    idx = as_tensors(stencil_tables(st), "cuda")["strip_idx"]
    _, P_l = fs.cfp_geometry(16, st.n_steps)
    xc = torch.randn(16 * 16, 12, 16, P_l, device="cuda")
    faces = list(range(12))
    per_call = {"op": [], "direct": []}
    for r in range(5):
        for nm, ns in ((("op", ops), ("direct", direct)) if r % 2 == 0
                       else (("direct", direct), ("op", ops))):
            per_call[nm].append(host_us(
                lambda: ns.strips(xc, idx, 16, st.n_steps, faces)))
    nside = 64
    npix = 12 * nside * nside
    model = dt.HealpyGCNN(nside, np.arange(npix),
                          quick_start_layers(hp_nn)).build((16, npix, 1),
                                                           seed=11)
    model.compile(optimizer=1e-3,
                  loss="sparse_categorical_crossentropy_from_logits")
    data = np.random.RandomState(12)
    xt = data.normal(size=(64, npix, 1)).astype(np.float32)
    yt = data.randint(0, 4, size=64)

    def step(i):
        j = 16 * (i % 4)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model._trainer.train_on_batch(xt[j:j + 16], yt[j:j + 16])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    for i in range(4):
        step(i)
    steps = {"op": [], "direct": []}
    for r in range(12):
        for nm, ns in ((("op", ops), ("direct", direct)) if r % 2 == 0
                       else (("direct", direct), ("op", ops))):
            with calling(ns):
                steps[nm].append(step(r))
    med = {k: float(np.median(v)) for k, v in per_call.items()}
    step_med = {k: float(np.median(v)) for k, v in steps.items()}
    q = {k: [float(x) for x in np.percentile(v, [25, 75])]
         for k, v in steps.items()}
    say("dispatch", f"K4 at nside 16, 256 channels: {med['op']:.2f} µs a "
        f"call through its op, {med['direct']:.2f} calling its CUDA "
        f"implementation directly (host, median of 5 x 2,000 calls in "
        f"turns); the quick_start train step (K2 route, 12 op calls) "
        f"{step_med['op']:.3f} ms with the ops, {step_med['direct']:.3f} ms "
        f"calling the implementations (medians of 12 in turns; quartiles "
        f"{q['op']} / {q['direct']}) on {card}")
    return {"per_call_us": per_call, "step_ms": steps}


def reference_tree(model, seed):
    """A Keras-3 ``.weights.h5`` group tree, as the importer reads one
    (``train.import_ref._read_tree``: nested dicts, ``vars`` lists), for
    ``model``'s convs (kernel, ``bn`` moving mean and variance) and dense
    head, from seeded numpy, with the empty groups Keras writes for the
    pools and ``Flatten``: what a TF2 user's checkpoint of quick_start
    holds."""
    from deepsphere_tpu_torch.interop import export_jax_variables
    from deepsphere_tpu_torch.train.import_ref import _BASE_NAME

    r = np.random.RandomState(seed)
    v = export_jax_variables(model)
    tree, seen = {}, {}
    for i, layer in enumerate(model.layers_use):
        cls = type(layer).__name__
        base = _BASE_NAME.get(cls) or {"HealpyPool": "healpy_pool",
                                       "Flatten": "flatten"}[cls]
        n = seen.get(base, 0)
        seen[base] = n + 1
        key = f"layers_{model.param_key(i)}"
        p, st = v["params"].get(key, {}), v["batch_stats"].get(key, {})
        group = {"vars": []}
        if cls == "ChebyshevConv":
            kern = p["kernel"]
            group["vars"] = [(r.normal(size=kern.shape) / np.sqrt(
                kern.shape[0])).astype(np.float32)]
            if st:
                F = st["bn"]["mean"].shape
                group["bn"] = {"vars": [
                    r.normal(scale=0.1, size=F).astype(np.float32),
                    r.uniform(0.5, 2.0, size=F).astype(np.float32)]}
        elif cls == "Dense":
            d = p["dense"]
            group["vars"] = [(r.normal(size=d["kernel"].shape) / np.sqrt(
                d["kernel"].shape[0])).astype(np.float32),
                r.normal(scale=0.1, size=d["bias"].shape).astype(np.float32)]
        tree[base if n == 0 else f"{base}_{n}"] = group
    return tree


def watch(model, rec):
    """Forward hooks that record, in NEST order on the CPU, each max pool's
    input under its key (the preceding conv's output after its ReLU) and
    the output of the last conv that no pool follows: the decisions a
    forward of ``model`` took.  Returns the hooks."""
    from deepsphere_tpu_torch.ops.layout import face_to_nest
    from deepsphere_tpu_torch.ops.stencil import cface_extract

    def nest(x, layout, off):
        if layout == "cface":
            x = cface_extract(x, off)
        return face_to_nest(x) if layout in ("cface", "face") else x

    hooks = []
    convs = [k for k in model.order if hasattr(model.layers[k], "n_terms")]
    for k in model.order:
        layer = model.layers[k]
        if getattr(layer, "pool_type", None) == "MAX":
            hooks.append(layer.register_forward_hook(
                lambda mod, inp, out, k=k: rec.__setitem__(k, nest(
                    inp[0].detach(), mod.layout, mod.cface_off).cpu())))
    last = model.layers[convs[-1]]
    if last.layout == "cface":
        raise NotImplementedError("watch: the last conv runs in cface")
    hooks.append(last.register_forward_hook(
        lambda mod, inp, out: rec.__setitem__(convs[-1], nest(
            out.detach(), mod.layout, 0).cpu())))
    return hooks


def follow(ref, rec):
    """Make the float64 NEST model ``ref`` take the decisions in ``rec``
    (:func:`watch`): each ReLU conv passes where the card's output was
    positive, each max pool takes the card's maxima (shared evenly where
    the card's tie).  Returns {layer key: the number of places where
    ``ref``'s own pick differs}, filled by ``ref``'s next forward."""
    order = list(ref.order)
    flips = {}

    def relu_as(key, mask):
        def act(y):
            flips[key] = int(((y > 0) != mask).sum())
            return y * mask.to(y.dtype)
        return act

    def share(x4):
        w = (x4 == x4.amax(2, keepdim=True)).to(torch.float64)
        return w / w.sum(2, keepdim=True)

    for key, c in rec.items():
        c = c.to(torch.float64)
        layer = ref.layers[key]
        if getattr(layer, "pool_type", None) == "MAX":
            conv = [k for k in order[:order.index(key)]
                    if hasattr(ref.layers[k], "n_terms")][-1]
            ref.layers[conv].activation = relu_as(conv, c > 0)
            B, M, F = c.shape
            w = share(c.reshape(B, M // 4, 4, F))

            def pool(mod, inp, out, w=w, key=key):
                x4 = inp[0].reshape(w.shape)
                flips[key] = int((share(x4) != w).any(2).sum())
                return (x4 * w).sum(2)

            layer.register_forward_hook(pool)
        else:
            layer.activation = relu_as(key, c > 0)
    return flips


def knn_phase(dev, card, rng):
    """14. The TF2 user's path: kNN graphs built without sklearn, a
    reference checkpoint's tree imported into quick_start on the kNN graph,
    served and trained on the card, with remat, a profiler window and the
    filters; and the k=20 kNN conv on the lap chain.  Returns the launches
    of the kNN and remat paths and the phase's numbers."""
    import tempfile

    import deepsphere_tpu_torch as dt
    from deepsphere_tpu_torch import config
    from deepsphere_tpu_torch.graph import build_sphere_graph
    from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
    from deepsphere_tpu_torch.ops import _cuda
    from deepsphere_tpu_torch.ops import fused_stencil as fs
    from deepsphere_tpu_torch.ops import stencil as tst
    from deepsphere_tpu_torch.ops.stencil import (
        as_tensors,
        stencil_graph_conv,
        stencil_tables,
    )
    from deepsphere_tpu_torch.train import import_ref
    from deepsphere_tpu_torch.train.losses import resolve_loss
    from deepsphere_tpu_torch.utils.profiling import trace

    loss_name = "sparse_categorical_crossentropy_from_logits"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nside = 64
    npix = 12 * nside * nside
    zero = {k: 0 for k in _cuda.launch_counts}
    out = {}

    # (a) the reference's kNN graphs on the card's host, with no sklearn
    graphs, graph_s = {}, {}
    for k in (8, 20):
        t = time.perf_counter()
        graphs[k] = build_sphere_graph(nside, k=k, method="knn")
        graph_s[k] = time.perf_counter() - t
    if "sklearn" in sys.modules:
        raise AssertionError("building a kNN graph imported sklearn")
    say("knn", f"kNN graphs at nside {nside} built without sklearn: k=8 in "
        f"{graph_s[8]:.2f} s, k=20 in {graph_s[20]:.2f} s (kernel widths "
        f"{graphs[8].kernel_width:.6f}, {graphs[20].kernel_width:.6f})")
    out["graph_s"] = graph_s

    # (b) quick_start on the kNN graph (k=8), its weights from a reference
    # checkpoint's tree, served and trained on the card
    t = time.perf_counter()
    model = dt.HealpyGCNN(nside, np.arange(npix), quick_start_layers(hp_nn),
                          n_neighbors=8, graph_method="knn")
    model.build((16, npix, 1), seed=41)
    cpu = copy.deepcopy(model).to("cpu")
    tree = reference_tree(model, 42)
    import_ref._import_tree(tree, model)
    import_ref._import_tree(tree, cpu)
    build_s = time.perf_counter() - t
    convs = [(key, m) for key, m in model.layers.items()
             if hasattr(m, "graph") and hasattr(m, "n_terms")]
    routes = []
    for (key, m), fin in zip(convs, (1, 8, 16, 32)):
        st = m._stencil()
        if m.layout == "cface":
            rt = fs.cface_route(st, "cheby", 10, 16, fin, m.kernel.shape[1],
                                sms)
        else:
            rt = tst.conv_route(st, "cheby", 10, True)
        routes.append((key, m.layout, st.radius, st.n_steps,
                       int(np.asarray(st.corr_out_face).shape[0]), rt))
    if routes[0][1] != "cface" or routes[0][5] != "fused":
        raise AssertionError(f"kNN conv 1 did not plan the fused cface "
                             f"route: {routes}")
    x = rng.normal(size=(4 * 16, npix, 1)).astype(np.float32)
    logits, srv, srv_rt = counted(lambda: model.predict(x, batch_size=16))
    want = {**zero, "strips": 4, "stencil_conv": 4}
    if srv != want or any(srv_rt.values()):
        raise AssertionError(f"kNN serving launched {srv}, routes {srv_rt}; "
                             f"expected {want}")
    ref = cpu.predict(x, batch_size=16)
    rel = float(np.abs(logits - ref).max() / np.abs(ref).max())
    if not (logits.shape == (64, 4) and np.all(np.isfinite(logits))
            and rel <= 1e-4):
        raise AssertionError(f"kNN logits {logits.shape} rel {rel:.3e} from "
                             "the CPU")
    xb = torch.from_numpy(x[:16]).to(dev)
    model.eval()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(xb), iters=20, warmup=3)
    say("knn", f"quick_start on the k=8 kNN graph, nside {nside}, full width:"
        f" built and imported from a reference tree ({sorted(tree)}) in "
        f"{build_s:.2f} s; conv routes (key, layout, radius, h, corrected "
        f"rows, route) {routes}; 4 requests x 16 maps launched {srv} (conv 1:"
        f" one K4 + one K1 a request; convs 2-4 per step, no kernel), all 64 logits "
        f"rel {rel:.2e} from the CPU; {fwd_ms:.3f} ms per forward of 16 maps "
        f"on {card}")
    out.update(routes=routes, serve_ms=fwd_ms)

    # one train step on each backward route against a float64 CPU step
    # that takes the card step's max-pool and ReLU decisions: where two
    # pooled values (or a pre-activation and 0) lie within float32 rounding
    # of each other, the card and float64 may pick differently, and the
    # gradient then moves by a whole pixel's share (a pool input tie at
    # 6e-8 of its max did so on this model in one run).  The reference
    # counts where its own picks differ.
    data = np.random.RandomState(43)
    xt = data.normal(size=(64, npix, 1)).astype(np.float32)
    yt = data.randint(0, 4, size=64)
    # conv 1 is the one cface conv; its input needs no gradient
    want_step = {True: {**zero, "strips": 2, "stencil_conv": 1, "dxdw": 1},
                 False: {**zero, "strips": 1, "stencil_conv": 1, "grad": 1}}
    init = copy.deepcopy(model)

    def step(fused, remat, decisions=None):
        """One train step of a copy of ``init`` on a route: (model, logs,
        launches, peak bytes over the bytes held before the step); with
        ``decisions`` a dict, the step's max-pool inputs and last conv's
        output are recorded there in NEST order (:func:`watch`)."""
        config.set_fused_dw(fused)
        m = copy.deepcopy(init)
        m.remat = remat
        m.compile(optimizer=1e-3, loss=loss_name)
        hooks = [] if decisions is None else watch(m, decisions)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        logs, c, r = counted(lambda: m._trainer.train_on_batch(xt[:16],
                                                               yt[:16]))
        peak = torch.cuda.max_memory_allocated(dev) - base
        for hk in hooks:
            hk.remove()
        if any(r.values()):
            raise AssertionError(f"the kNN step took the routes {r}")
        return m, logs, c, peak

    def ref_step(rec):
        """The float64 step on the decisions ``rec``: (loss, gradients, BN
        statistics, {layer: picks of its own that differ})."""
        cpu64 = nest_reference(dt, model, nside, quick_start_layers(hp_nn),
                               n_neighbors=8, graph_method="knn")
        flips = follow(cpu64, rec)
        cpu64.train()
        out64 = cpu64(torch.from_numpy(xt[:16].astype(np.float64)))
        loss64 = resolve_loss(loss_name)(torch.from_numpy(yt[:16]), out64)
        loss64.backward()
        return float(loss64.detach()), grads_of(cpu64), stats_of(cpu64), flips

    steps, remats, seen = {}, {}, {}
    try:
        for fused in (True, False):
            seen[fused] = {}
            steps[fused] = step(fused, False, seen[fused])
        same = all(torch.equal(seen[True][k], seen[False][k])
                   for k in seen[True])
        t64 = time.perf_counter()
        refs = {True: ref_step(seen[True])}
        refs[False] = refs[True] if same else ref_step(seen[False])
        cpu_s = time.perf_counter() - t64
        for fused in (True, False):
            m, logs, c, peak = steps[fused]
            loss64, g64, s64, flips = refs[fused]
            g, st_ = grads_of(m), stats_of(m)
            loss_rel = abs(logs["loss"] - loss64) / abs(loss64)
            g_err, s_err = tree_errs(g, g64), tree_errs(st_, s64)
            bad = {**held(g_err, GRAD_TOL), **held(s_err, BN_TOL)}
            if c != want_step[fused] or not loss_rel <= 1e-5 or bad:
                raise AssertionError(
                    f"kNN step fused_dw={fused}: launched {c} (expected "
                    f"{want_step[fused]}), loss rel {loss_rel:.3e}, errors "
                    f"above {GRAD_TOL} / {BN_TOL}: {bad} (float64 picks "
                    f"that differ from the card's: {flips})")
            steps[fused] = (m, c, loss_rel, max(g_err.values()),
                            max(s_err.values()), peak, logs, g, st_)
            # (c) the same model with remat: each layer recomputed in the
            # backward, the forward's kernels launched again, the running
            # statistics updated once
            mr, logs_r, c_r, peak_r = step(fused, True)
            e_loss = abs(logs_r["loss"] - logs["loss"]) / abs(logs["loss"])
            e_g = max(tree_errs(grads_of(mr), g).values())
            e_s = max(tree_errs(stats_of(mr), st_).values())
            extra = {k: c_r[k] - c[k] for k in c}
            if extra != {**zero, "strips": 1, "stencil_conv": 1} or not (
                    e_loss <= 1e-6 and e_g <= 1e-6 and e_s <= 1e-6):
                raise AssertionError(
                    f"remat step fused_dw={fused}: launched {c_r} against "
                    f"{c}, loss {e_loss:.3e}, gradients {e_g:.3e}, BN "
                    f"{e_s:.3e} from the plain step")
            remats[fused] = (mr, c_r, e_loss, e_g, e_s, peak_r)
    finally:
        config.set_fused_dw(True)
    step_ms, _ = time_routes(config, {f: steps[f][0]._trainer
                                      for f in (True, False)}, xt, yt)
    remat_ms, _ = time_routes(config, {f: remats[f][0]._trainer
                                       for f in (True, False)}, xt, yt)
    # a profiler window of 3 K2-route steps, written as a trace
    tr = steps[True][0]._trainer
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            for i in range(3):
                tr.train_on_batch(xt[16 * i:16 * i + 16], yt[16 * i:16 * i + 16])
        trace_mb = os.path.getsize(prof.trace_path) / 1e6
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    scopes = [f"{type(m).__name__}_{key}" for key, m in model.layers.items()]
    missing = [sc for sc in scopes if sc not in names]
    kern = [e for e in events if e.get("cat") == "kernel"]
    ours = {nm: sum(nm in e["name"] for e in kern) for nm in (
        "strips_kernel", "stencil_conv_kernel", "stencil_bwd_kernel")}
    if missing or not all(ours.values()):
        raise AssertionError(f"the trace lacks the layer scopes {missing} or "
                             f"the kernels' launches {ours}")
    busy = sum(e.get("dur", 0) for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")) / 1e3 / 3
    # host ms a step inside each layer's scope (its forward; the backward
    # runs outside the scopes), the largest first
    layer_ms = {sc: sum(e.get("dur", 0) for e in events
                        if e.get("name") == sc) / 1e3 / 3 for sc in scopes}
    top_layers = sorted(layer_ms.items(), key=lambda kv: -kv[1])[:5]
    say("knn", f"one train_on_batch of 16 maps (float64 CPU step "
        f"{cpu_s:.1f} s, on the card's max-pool and ReLU decisions; its own "
        f"picks differ at {refs[True][3]} on the K2 route's, "
        f"{refs[False][3]} on the K1+K3 route's): K2 route launched {steps[True][1]}, loss rel "
        f"{steps[True][2]:.2e}, gradients {steps[True][3]:.2e}, BN "
        f"{steps[True][4]:.2e}; K1+K3 route launched {steps[False][1]}, loss "
        f"rel {steps[False][2]:.2e}, gradients {steps[False][3]:.2e}, BN "
        f"{steps[False][4]:.2e}; ms per step (median of 10, routes "
        f"alternating): K2 {step_ms[True]:.3f}, K1+K3 {step_ms[False]:.3f}; "
        f"trace of 3 K2-route steps ({trace_mb:.1f} MB): all {len(scopes)} "
        f"layer scopes, kernel events {ours}, device busy {busy:.3f} ms per "
        f"step = {busy / step_ms[True]:.1%} of the unprofiled step; host ms "
        f"a step in the largest layer scopes (forward) "
        + ", ".join(f"{sc} {ms:.3f}" for sc, ms in top_layers)
        + f" on {card}")
    say("remat", f"remat=True: K2 route launched {remats[True][1]}, K1+K3 "
        f"{remats[False][1]} (the forward's K4 and K1 once more a step); "
        f"against the plain step on the card: loss "
        f"{max(remats[f][2] for f in remats):.2e}, gradients "
        f"{max(remats[f][3] for f in remats):.2e}, BN "
        f"{max(remats[f][4] for f in remats):.2e}; peak bytes over the "
        f"model's during a step: plain K2 {steps[True][5]:,} / K1+K3 "
        f"{steps[False][5]:,}, remat K2 {remats[True][5]:,} / K1+K3 "
        f"{remats[False][5]:,}; ms per step: remat K2 {remat_ms[True]:.3f}, "
        f"K1+K3 {remat_ms[False]:.3f} against {step_ms[True]:.3f} / "
        f"{step_ms[False]:.3f} on {card}")
    out.update(step_ms=step_ms, remat_ms=remat_ms, busy_ms=busy,
               layer_ms=dict(top_layers),
               peak={"plain": {f: steps[f][5] for f in steps},
                     "remat": {f: remats[f][5] for f in remats}})
    knn_paths = [srv, steps[True][1], steps[False][1]]
    remat_paths = [remats[True][1], remats[False][1]]
    del steps, remats, init, tr

    # (d) the k=20 kNN graph's Chebyshev K=10 conv, 8 -> 16 channels, batch
    # 16, NEST: the radius-3 capture window, one L~ application a launch
    K, B, Fin, Fout = 10, 16, 8, 16
    st20 = graphs[20].face_stencil(0.75)
    tab20 = as_tensors(stencil_tables(st20), dev)
    if (st20.radius, st20.n_steps) != (3, 3) or tst.conv_route(
            st20, "cheby", K, True) != "chain":
        raise AssertionError("the k=20 kNN conv does not take the lap chain")
    x20 = torch.from_numpy(rng.normal(size=(B, npix, Fin)).astype(np.float32)).to(dev)
    k20 = torch.from_numpy((rng.normal(size=(Fin * K, Fout))
                            / np.sqrt(Fin * K)).astype(np.float32)).to(dev)
    cot20 = torch.from_numpy(rng.normal(size=(B, npix, Fout)).astype(np.float32)).to(dev)
    chain = lambda a, w: stencil_graph_conv(st20, a, w, K, "cheby",
                                            tables=tab20, layout="nest")
    plain = lambda a, w: tst._per_step(st20, a, w, K, "cheby", tab20, "nest")
    with torch.no_grad():
        y_c, fwd20, rt20 = counted(lambda: chain(x20, k20))
        y_p = plain(x20, k20)
    e20 = rel_err(y_c, y_p)
    if fwd20 != chain_launches(K - 1) or rt20["lap_chain"] != 1 or not (
            e20 <= TOL):
        raise AssertionError(f"k=20 kNN chain forward launched {fwd20}, "
                             f"routes {rt20}, rel err {e20:.3e}")
    xl = x20.clone().requires_grad_()
    kl = k20.clone().requires_grad_()
    dx_p, dk_p = torch.autograd.grad(plain(xl, kl), (xl, kl), cot20)
    bwd20 = {}
    try:
        for fused in (True, False):
            config.set_fused_dw(fused)
            (dx_c, dk_c), c, r = counted(lambda: torch.autograd.grad(
                chain(xl, kl), (xl, kl), cot20))
            e_dx, e_dk = rel_err(dx_c, dx_p), rel_err(dk_c, dk_p)
            if c != chain_launches(K - 1, fused) or r["lap_chain"] != 1 or \
                    not (e_dx <= TOL and e_dk <= DW_TOL):
                raise AssertionError(
                    f"k=20 kNN chain fwd + bwd fused_dw={fused}: launched "
                    f"{c}, routes {r}, dx rel {e_dx:.3e}, dW rel {e_dk:.3e}")
            bwd20[fused] = (c, e_dx, e_dk)
    finally:
        config.set_fused_dw(True)
    with torch.no_grad():
        ms_chain = cuda_ms(lambda: chain(x20, k20), iters=5, warmup=1)
        ms_plain = cuda_ms(lambda: plain(x20, k20), iters=5, warmup=1)
    say("knn chain", f"k=20 kNN graph nside {nside}, Chebyshev K={K}, B={B}, "
        f"{Fin} -> {Fout}, NEST: route chain, a forward launched {fwd20}, "
        f"rel err vs the per-step path {e20:.2e}; fwd + bwd K2 route launched "
        f"{bwd20[True][0]} (dx {bwd20[True][1]:.2e}, dW {bwd20[True][2]:.2e}),"
        f" K1+K3 route {bwd20[False][0]} (dx {bwd20[False][1]:.2e}, dW "
        f"{bwd20[False][2]:.2e}); forward {ms_chain:.3f} ms on the chain, "
        f"{ms_plain:.3f} ms per step (CUDA events) on {card}")
    out.update(chain_ms=ms_chain, chain_plain_ms=ms_plain)
    knn_paths += [fwd20, bwd20[True][0], bwd20[False][0]]
    del x20, k20, cot20, xl, kl, dx_p, dk_p, y_c, y_p, tab20

    # (e) the trained filters of conv 1 on the card against the CPU model's
    pix = [0, 100, 1000]
    banks = model.get_filters(0)
    if banks[0].device.type != "cuda":
        raise AssertionError(f"the filter bank lives on {banks[0].device}")
    loc = banks[0].localize(pix)
    loc_cpu = cpu.get_filters(0)[0].localize(pix)
    e_loc = float(np.abs(loc - loc_cpu).max() / np.abs(loc_cpu).max())
    if loc.shape != (3, 1, 8, npix) or not e_loc <= 1e-5:
        raise AssertionError(f"localized filters {loc.shape} rel {e_loc:.3e} "
                             "from the CPU")
    say("filters", f"get_filters(0)[0].localize({pix}) on the card: "
        f"{loc.shape}, rel {e_loc:.2e} from the CPU model's")

    def total(counts):
        s = dict(zero)
        for c in counts:
            for k, v in c.items():
                s[k] += v
        return s

    del model, cpu
    return {"knn": total(knn_paths), "remat": total(remat_paths)}, out


BF_TOL = 1e-2  # a bf16 kernel's y or dx against its plain bf16 version
BF_DW_TOL = 1e-3  # a bf16 kernel's dW against its plain bf16 version
BF_F32_TOL = 3e-2  # a bf16 conv against the float32 conv, of max|f32|
# the least distance of a bf16 result from the float32 one on the same
# values, of max|f32|: a bf16 instantiation or mode that skipped its own
# rounding would sit within the float32 kernels' 2e-5 of it.  A raw
# kernel's dW moves less than y and dx where its inputs are bf16 already
# and K is small (T_0 x = x is exact), hence its own bound
BF_MOVED = 1e-3
BF_DW_MOVED = 1e-4
# quick_start's first bf16 train step's gradients against the float32
# step's, of each leaf's max: batch norm on batch statistics, ReLU and
# max-pool make them ill-conditioned (15(c) prints how far the float32
# step's own gradients move when only its batch is rounded to bf16)
BF_STEP_TOL = 0.5
BF_MODES = ("bfloat16", "bfloat16_io")


def bf16_apart(what, got, f32, least=BF_MOVED):
    """The distance of a bfloat16 result from the float32 one, of
    max|f32|; raises where it is not farther than ``least`` (the rounding
    was skipped) or, where ``f32`` is all zero (a dW whose rows the corner
    correction all recomputes), where ``got`` is not zero too."""
    got, f32 = got.float(), f32.float()
    if f32.abs().max() == 0:
        if got.abs().max() != 0:
            raise AssertionError(f"{what}: nonzero where float32 is zero")
        return 0.0
    d = rel_err(got, f32)
    if not d > least:
        raise AssertionError(f"{what}: {d:.3e} from float32 (at least "
                             f"{least}): not rounded to bfloat16")
    return d


def bf16_phase(dev, card, rng, qs_st, st1024, results, serve_ms):
    """15. The bfloat16 modes (``config.conv_dtype``): (a) K1, K2 and K3 in
    the band mode and the I/O mode (and K4 on the I/O mode's bfloat16
    strips) against their plain bfloat16 versions at the quick_start shapes
    and the headline, and apart from the float32 kernels on the same
    values; (b) the headline conv's forward and train step in each mode
    against the float32 conv; (c) quick_start's first train step on each
    route and its served logits in each mode against float32's, three
    train steps, and the model exported and replayed under "bfloat16_io";
    (d) the radius-3 conv's 2-byte kernels as in (a), and its forward and
    train step in each mode against the float32 conv.
    Every bf16 result must also lie farther than ``BF_MOVED`` from the
    float32 one.  Returns the paths' launches (each counted from 0)."""
    import shutil
    import tempfile

    import deepsphere_tpu_torch as dt
    from deepsphere_tpu_torch import config
    from deepsphere_tpu_torch.graph import build_sphere_graph
    from deepsphere_tpu_torch.interop import export_jax_variables
    from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
    from deepsphere_tpu_torch.ops import _cuda
    from deepsphere_tpu_torch.ops import fused_stencil as fs
    from deepsphere_tpu_torch.ops.stencil import (
        as_tensors,
        cface_embed,
        cface_extract,
        stencil_tables,
    )
    from deepsphere_tpu_torch.ops.strips import (
        build_strips,
        strip_arrays,
        strip_index_map,
    )

    t_phase = time.perf_counter()
    for k in ("strips_bf16", "stencil_conv_bf16", "stencil_conv_bf16_io",
              "dxdw_bf16", "dxdw_bf16_io", "grad_bf16", "grad_bf16_io",
              "stencil_conv_bf16_s2", "stencil_conv_bf16_io_s2",
              "dxdw_bf16_s2", "dxdw_bf16_io_s2", "grad_bf16_s2",
              "grad_bf16_io_s2"):
        results[k] = []
    f32_ms = {(k, r[0]): r[2] for k in ("stencil_conv", "dxdw", "grad",
                                          "strips") for r in results[k]}
    nan = float("nan")  # no float32 time in phase 3 at this shape

    def counts():
        return {**_cuda.launch_counts, **_cuda.bf16_launch_counts}

    def since(before, into=None):
        """The launches since ``before`` (nonzero), added into ``into``."""
        d = {k: v - before[k] for k, v in counts().items() if v - before[k]}
        if into is not None:
            for k, v in d.items():
                into[k] = into.get(k, 0) + v
        return d

    def check(what, got, want, tol):
        err = rel_err(got.float(), want.float())
        if not err <= tol:
            raise AssertionError(f"{what}: rel err {err:.3e} (tol {tol})")
        return err, (got.float() - want.float()).abs().max().item()

    def launched(fn, *a):
        """``fn(*a)`` and the one kernel count it raised."""
        before = counts()
        out = fn(*a)
        keys = list(since(before))
        if len(keys) != 1:
            raise AssertionError(f"{fn.__name__}: launched {keys}")
        return out, keys[0]

    def kernels_case(label, st, B, Fin, Fout, K, strips=True):
        """K1, K2 and K3 in each mode (and K4 on 2-byte strips, where
        ``strips``) against their plain versions and apart from the float32
        kernels, timed, into ``results`` under the count each launch raised
        (the 2-byte stagings' "_s2" where the shape takes them)."""
        n, h = st.nside, st.n_steps
        _, P_l = fs.cfp_geometry(n, h)
        if not fs.cfp_io_available(st):
            raise AssertionError(f"{label}: no bf16 I/O for this conv")
        tables = as_tensors(stencil_tables(st, bf16_io=True), dev)
        mask = tables.get("corr_mask")
        x32 = torch.from_numpy(
            rng.normal(size=(B * Fin, 12, n, P_l)).astype(np.float32)).to(dev)
        dy32 = torch.from_numpy(
            rng.normal(size=(B * Fout, 12, n, P_l)).astype(np.float32)).to(dev)
        kernel = torch.from_numpy((rng.normal(size=(Fin * K, Fout))
                                   / np.sqrt(Fin * K)).astype(np.float32)).to(dev)
        wk3 = kernel.reshape(Fin, K, Fout).permute(1, 0, 2).contiguous()
        wk3t = kernel.reshape(Fin, K, Fout).permute(1, 2, 0).contiguous()
        inner = slice(h, h + n)
        line = []
        for io in (False, True):
            es = 2 if io else 4
            xc = x32.to(torch.bfloat16) if io else x32
            dy = dy32.to(torch.bfloat16) if io else dy32
            w = tables["weights_bf16" if io else "weights"]
            sx, sdy = strip_arrays(st, xc), strip_arrays(st, dy)
            if io and strips:  # K4 on 2-byte elements, against plain
                idx = tables["strip_idx_bf16"]
                got = build_strips(st, xc, idx)
                for g, want in zip(got, sx):
                    if not torch.equal(g.view(torch.int16),
                                       want.view(torch.int16)):
                        raise AssertionError(f"{label}: bf16 strips differ")
                R = sx[0].shape[2]
                slab = 12 * n * P_l
                xz = torch.cat([xc.reshape(B * Fin, slab),
                                xc.new_zeros((B * Fin, 1))], dim=1)
                sel = torch.where(idx >= 0, idx, slab).long()
                ms4 = graph_ms(lambda: build_strips(st, xc, idx))
                ms4p = cuda_ms(lambda: strip_arrays(st, xc), iters=3, warmup=1)
                ms4l = graph_ms(lambda: torch.index_select(xz, 1, sel))
                src = np.unique(strip_index_map(st, torch.bfloat16))
                nb = (int((src >= 0).sum()) * B * Fin
                      + B * Fin * (2 * 12 * R * P_l + 12 * n * 128)) * 2
                results["strips_bf16"].append(
                    (label, 0.0, ms4, ms4p, *bound(nb, 0), ms4l))
                line.append(f"K4 bf16 exact {ms4:.4f} ms (f32 "
                            f"{f32_ms[('strips', label)]:.4f}, plain "
                            f"{ms4p:.4f}, index_select {ms4l:.4f})")
            # the float32 kernels on the same values (the weight planes
            # rounded as the bf16 ones): what a bf16 instantiation that
            # skipped its own rounding would return
            xf, dyf = xc.float(), dy.float()
            wf = tables["weights"].to(torch.bfloat16).float()
            sxf, sdyf = strip_arrays(st, xf), strip_arrays(st, dyf)
            y_f = fs.run_stencil_kernel(st, "cheby", K, xf, wf, sxf, wk3, B)
            dx_f, dw_f = fs.run_dxdw_kernel(st, "cheby", K, dyf, wf, sdyf,
                                            wk3t, xf, mask, B)
            g_f = fs.run_grad_kernel(st, "cheby", K, xf, wf, sxf, dyf, B)
            # K1
            a1 = (st, "cheby", K, xc, w, sx, wk3, B, "bfloat16")
            y_k, k1 = launched(fs.run_stencil_kernel, *a1)
            y_p = fs.run_stencil_plain(*a1)
            torch.cuda.synchronize()
            e1, abs1 = check(f"{label} {k1}", y_k[..., inner],
                             y_p[..., inner], BF_TOL)
            if (y_k.dtype != xc.dtype or y_k[..., :h].abs().max() != 0
                    or y_k[..., h + n:].abs().max() != 0):
                raise AssertionError(f"{label} {k1}: dtype {y_k.dtype} "
                                     "or pad lanes")
            d1 = bf16_apart(f"{label} {k1}", y_k[..., inner],
                            y_f[..., inner])
            ms1 = graph_ms(lambda: fs.run_stencil_kernel(*a1))
            ms1p = cuda_ms(lambda: fs.run_stencil_plain(*a1), iters=3,
                           warmup=1)
            b1 = k1_bound(st, K, B, Fin, Fout, es)
            results[k1].append((label, abs1, ms1, ms1p, *b1, None))
            # K2
            a2 = (st, "cheby", K, dy, w, sdy, wk3t, xc, mask, B, "bfloat16")
            (dx_k, dw_k), k2 = launched(fs.run_dxdw_kernel, *a2)
            _, dw_k2 = fs.run_dxdw_kernel(*a2)
            dx_p, dw_p = fs.run_dxdw_plain(*a2)
            torch.cuda.synchronize()
            e2x, abs2x = check(f"{label} {k2} dx", dx_k[..., inner],
                               dx_p[..., inner], BF_TOL)
            e2w, abs2w = check(f"{label} {k2} dW", dw_k, dw_p, BF_DW_TOL)
            if not torch.equal(dw_k, dw_k2):
                raise AssertionError(f"{label} {k2}: dW not repeatable")
            d2x = bf16_apart(f"{label} {k2} dx", dx_k[..., inner],
                             dx_f[..., inner])
            d2w = bf16_apart(f"{label} {k2} dW", dw_k, dw_f, BF_DW_MOVED)
            ms2 = graph_ms(lambda: fs.run_dxdw_kernel(*a2))
            ms2p = cuda_ms(lambda: fs.run_dxdw_plain(*a2), iters=3, warmup=1)
            b2 = bwd_bound(st, K, B, Fin, Fout, True, es, mask is not None)
            results[k2].append((label, max(abs2x, abs2w), ms2, ms2p, *b2,
                                None))
            # K3
            a3 = (st, "cheby", K, xc, w, sx, dy, B, "bfloat16")
            g_k, k3 = launched(fs.run_grad_kernel, *a3)
            g_k2 = fs.run_grad_kernel(*a3)
            g_p = fs.run_grad_plain(*a3)
            torch.cuda.synchronize()
            e3, abs3 = check(f"{label} {k3} dW", g_k, g_p, BF_DW_TOL)
            if not torch.equal(g_k, g_k2):
                raise AssertionError(f"{label} {k3}: dW not repeatable")
            d3 = bf16_apart(f"{label} {k3} dW", g_k, g_f, BF_DW_MOVED)
            del xf, dyf, wf, sxf, sdyf, y_f, dx_f, dw_f, g_f
            ms3 = graph_ms(lambda: fs.run_grad_kernel(*a3))
            ms3p = cuda_ms(lambda: fs.run_grad_plain(*a3), iters=3, warmup=1)
            b3 = bwd_bound(st, K, B, Fin, Fout, False, es)
            results[k3].append((label, abs3, ms3, ms3p, *b3, None))
            line.append(
                f"{'I/O' if io else 'band'}: {k1} rel {e1:.2e} {ms1:.4f} ms "
                f"(f32 {f32_ms.get(('stencil_conv', label), nan):.4f}, plain "
                f"{ms1p:.4f}, bound {b1[0]:.4f} {b1[1]}) | {k2} dx rel "
                f"{e2x:.2e} dW rel {e2w:.2e} {ms2:.4f} ms (f32 "
                f"{f32_ms.get(('dxdw', label), nan):.4f}, plain {ms2p:.4f}, bound "
                f"{b2[0]:.4f} {b2[1]}) | {k3} dW rel {e3:.2e} {ms3:.4f} ms (f32 "
                f"{f32_ms.get(('grad', label), nan):.4f}, plain {ms3p:.4f}, bound "
                f"{b3[0]:.4f} {b3[1]}) | from f32: y {d1:.2e} dx {d2x:.2e} "
                f"dW {d2w:.2e} / {d3:.2e}")
        say("bf16", f"{label}: " + " || ".join(line))
        del x32, dy32, tables
        torch.cuda.empty_cache()

    # (a) the kernels at the quick_start shapes and the headline
    for n, Fin, Fout in [(64, 1, 8), (32, 8, 16), (16, 16, 32)]:
        kernels_case(f"quick_start nside={n} B=16 Fin={Fin} Fout={Fout} K=10",
                     qs_st[n], 16, Fin, Fout, 10)
    kernels_case("headline nside=1024 B=4 Fin=4 Fout=4 K=5", st1024, 4, 4, 4,
                 5)
    say("bf16", f"(a) done in {time.perf_counter() - t_phase:.1f} s")

    paths = {}
    # (b) the headline conv in each mode against the float32 conv
    B, Fin, Fout, K = 4, 4, 4, 5
    n, h = 1024, st1024.n_steps
    M = 12 * n * n
    tables = as_tensors(stencil_tables(st1024, bf16_io=True), dev)
    xf = torch.from_numpy(rng.normal(size=(B, M, Fin)).astype(np.float32)).to(dev)
    kernel = torch.from_numpy(
        (rng.normal(size=(Fin * K, Fout)) / np.sqrt(Fin * K)).astype(np.float32)
    ).to(dev)
    cot = torch.from_numpy(rng.normal(size=(B, M, Fout)).astype(np.float32)).to(dev)
    xl = xf.clone().requires_grad_()
    kl = kernel.clone().requires_grad_()

    def fwd():
        xc = cface_embed(xf, n, h).reshape(B * Fin, 12, n, -1)
        y = fs.fused_stencil_conv_cfp(st1024, tables, xc, kernel, K, "cheby", B)
        return cface_extract(y.reshape(B, Fout, 12, n, -1), h)

    def step():
        xc = cface_embed(xl, n, h).reshape(B * Fin, 12, n, -1)
        y = fs.fused_stencil_conv_cfp(st1024, tables, xc, kl, K, "cheby", B)
        yi = cface_extract(y.reshape(B, Fout, 12, n, -1), h)
        return torch.autograd.grad(yi, (xl, kl), cot.to(yi.dtype))

    with torch.no_grad():
        y32 = fwd().float()
    dx32, dk32 = step()
    ms32 = cuda_ms(lambda: fwd(), iters=10, warmup=2)
    head = []
    # the path's launches: one forward and one train step a route a mode
    # (not the timed repetitions)
    paths["bf16_headline"] = {}
    for mode in BF_MODES:
        config.set_conv_dtype(mode)
        try:
            with torch.no_grad():
                before = counts()
                y = fwd()
                torch.cuda.synchronize()
                since(before, paths["bf16_headline"])
                ey, _ = check(f"headline {mode} y", y, y32, BF_F32_TOL)
                bf16_apart(f"headline {mode} y", y, y32)
                ms_f = cuda_ms(lambda: fwd(), iters=10, warmup=2)
            tr = {}
            for fused_dw in (True, False):
                config.set_fused_dw(fused_dw)
                before = counts()
                dx, dk = step()
                torch.cuda.synchronize()
                since(before, paths["bf16_headline"])
                ex, _ = check(f"headline {mode} fused_dw={fused_dw} dx", dx,
                              dx32, BF_F32_TOL)
                ek, _ = check(f"headline {mode} fused_dw={fused_dw} dW", dk,
                              dk32, BF_F32_TOL)
                bf16_apart(f"headline {mode} fused_dw={fused_dw} dx", dx, dx32)
                bf16_apart(f"headline {mode} fused_dw={fused_dw} dW", dk, dk32)
                tr[fused_dw] = (cuda_ms(step, iters=5, warmup=1), ex, ek)
        finally:
            config.set_fused_dw(True)
            config.set_conv_dtype("float32")
        head.append(f"{mode}: y rel {ey:.2e}, forward {ms_f:.3f} ms (f32 "
                    f"{ms32:.3f}); train step K2 {tr[True][0]:.3f} ms (dx rel "
                    f"{tr[True][1]:.2e}, dW rel {tr[True][2]:.2e}), K1+K3 "
                    f"{tr[False][0]:.3f} ms (dx rel {tr[False][1]:.2e}, dW rel "
                    f"{tr[False][2]:.2e})")
    say("bf16", "(b) headline conv nside 1024 K=5 4 -> 4 B=4 against float32 "
        f"(tol {BF_F32_TOL}, each farther than {BF_MOVED}): "
        + "; ".join(head) + f"; launches "
        f"{paths['bf16_headline']} on {card}")
    del tables, xf, xl, kl, cot, y32, dx32, dk32
    torch.cuda.empty_cache()

    # (c) quick_start trained and served in each mode, exported under I/O
    nside = 64
    npix = 12 * nside * nside
    data = np.random.RandomState(12)
    xt = data.normal(size=(48, npix, 1)).astype(np.float32)
    yt = data.randint(0, 4, size=48)
    loss_name = "sparse_categorical_crossentropy_from_logits"
    ref = serving_model(dt, hp_nn)
    logits32 = ref.predict(xt[:16], batch_size=16)
    del ref

    def build():
        m = dt.HealpyGCNN(nside=nside, indices=np.arange(npix),
                          layers=quick_start_layers(hp_nn))
        m.build((16, npix, 1), seed=11)
        return m

    def first_steps(m, x, routes=(True, False)):
        """One train step of a copy of ``m`` on the batch ``x`` on each
        ``config.fused_dw`` route: {route: (loss, gradients)}."""
        out = {}
        try:
            for fused_dw in routes:
                config.set_fused_dw(fused_dw)
                c = copy.deepcopy(m)
                c.compile(optimizer=1e-3, loss=loss_name)
                loss = c._trainer.train_on_batch(x, yt[:16])["loss"]
                out[fused_dw] = (float(loss), grads_of(c))
        finally:
            config.set_fused_dw(True)
        return out

    # the float32 first steps, and how far the float32 step's own gradients
    # move when only its batch is rounded to bfloat16 (their conditioning)
    m32 = build()
    p32 = export_jax_variables(m32)["params"]
    first32 = first_steps(m32, xt[:16])
    xr = torch.from_numpy(xt[:16]).to(torch.bfloat16).float().numpy()
    cond = max(tree_errs(first_steps(m32, xr, (True,))[True][1],
                         first32[True][1]).values())
    del m32
    sfx = {"bfloat16": "_bf16", "bfloat16_io": "_bf16_io"}
    qs = {}
    for mode in BF_MODES:
        config.set_conv_dtype(mode)
        try:
            t = time.perf_counter()
            m = build()
            # the first step on each route from float32's weights and batch
            same = all(e == 0 for e in tree_errs(
                export_jax_variables(m)["params"], p32).values())
            first = []
            for fused_dw, (loss, g) in first_steps(m, xt[:16]).items():
                loss32, g32 = first32[fused_dw]
                e_loss = abs(loss - loss32) / abs(loss32)
                errs = tree_errs(g, g32)
                bad = {k: e for k, e in errs.items()
                       if not BF_MOVED < e <= BF_STEP_TOL}
                if not same or not e_loss <= BF_F32_TOL or bad:
                    raise AssertionError(
                        f"quick_start {mode} first step fused_dw={fused_dw}:"
                        f" weights as float32's {same}, loss rel {e_loss:.3e}"
                        f" (tol {BF_F32_TOL}), gradients outside ({BF_MOVED},"
                        f" {BF_STEP_TOL}]: {bad}")
                first.append(f"{'K2' if fused_dw else 'K1+K3'} loss rel "
                             f"{e_loss:.2e}, gradients "
                             f"{min(errs.values()):.2e}-"
                             f"{max(errs.values()):.2e}")
            m.compile(optimizer=1e-3, loss=loss_name)
            _cuda.reset_launch_counts()  # the route counts too
            qs_path = paths[f"bf16_quick_start{sfx[mode]}"] = {}
            losses, step_counts = [], []
            for i, fused_dw in enumerate((True, False, True)):
                config.set_fused_dw(fused_dw)
                before = counts()
                losses.append(m._trainer.train_on_batch(
                    xt[16 * i:16 * i + 16], yt[16 * i:16 * i + 16])["loss"])
                torch.cuda.synchronize()
                step_counts.append(since(before, qs_path))
            config.set_fused_dw(True)
            s_ = sfx[mode]
            io = mode == "bfloat16_io"
            # conv 1's input needs no gradient: its K1+K3 route skips dx.
            # Conv 1's K2 stages 2-byte elements (float32 ones would cost
            # it a block an SM: fused_stencil._bwd_bf16_staging)
            want_k2 = {"strips" + ("_bf16" if io else ""): 6,
                       "stencil_conv" + s_: 3, "dxdw" + s_: 2,
                       "dxdw" + s_ + "_s2": 1}
            want_k13 = {"strips" + ("_bf16" if io else ""): 5,
                        "stencil_conv" + s_: 5, "grad" + s_: 3}
            if (step_counts != [want_k2, want_k13, want_k2]
                    or not all(np.isfinite(losses))
                    or _cuda.route_counts["per_step_cface"]):
                raise AssertionError(f"quick_start {mode}: steps launched "
                                     f"{step_counts}, losses {losses}, routes "
                                     f"{_cuda.route_counts}")
            train_s = time.perf_counter() - t
            # served: serving_model's weights, against the float32 logits
            sm = serving_model(dt, hp_nn)
            before = counts()
            logits = sm.predict(xt[:16], batch_size=16)
            torch.cuda.synchronize()
            serve_counts = since(before, qs_path)
            el = float(np.abs(logits - logits32).max()
                       / np.abs(logits32).max())
            if not (np.all(np.isfinite(logits)) and logits.shape == (16, 4)
                    and BF_MOVED < el <= BF_F32_TOL
                    and serve_counts == {"strips" + ("_bf16" if io else ""): 3,
                                         "stencil_conv" + s_: 3}):
                raise AssertionError(f"quick_start {mode} served: logits rel "
                                     f"{el:.3e}, launches {serve_counts}")
            xb = torch.from_numpy(xt[:16]).to(dev)
            sm.eval()
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: sm(xb), iters=20, warmup=3)
            qs[mode] = (sm, logits)
            say("bf16", f"(c) quick_start {mode}: first step against "
                f"float32's (loss tol {BF_F32_TOL}, gradients of each leaf's"
                f" max in ({BF_MOVED}, {BF_STEP_TOL}]; the float32 step's "
                f"own on its batch rounded to bf16: {cond:.2e}): "
                + "; ".join(first) + "; 3 train steps (K2, K1+K3, "
                f"K2) losses {[round(float(v), 6) for v in losses]}, launches "
                f"{step_counts} ({train_s:.1f} s with the build); served 16 "
                f"maps: launches {serve_counts}, logits rel {el:.2e} from "
                f"float32 (in ({BF_MOVED}, {BF_F32_TOL}]), {fwd_ms:.3f} ms a "
                f"forward (float32 phase 4 "
                f"{serve_ms:.3f}) on {card}")
            if not io:
                del sm
        finally:
            config.set_fused_dw(True)
            config.set_conv_dtype("float32")

    # the I/O model exported under its mode, replayed in a fresh process
    sm, live = qs["bfloat16_io"]
    here = os.path.abspath(__file__)
    tmp = tempfile.mkdtemp(prefix="ds_bf16_export_")
    try:
        config.set_conv_dtype("bfloat16_io")
        try:
            path = os.path.join(tmp, "qs_bf16_io.pt2")
            t = time.perf_counter()
            nbytes = sm.save_exported(path)
            export_s = time.perf_counter() - t
        finally:
            config.set_conv_dtype("float32")
        x_path = os.path.join(tmp, "x.npy")
        np.save(x_path, xt[:16])
        res = subprocess.run([sys.executable, here, "--replay", path, x_path,
                              tmp, "16", "bfloat16_io"],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"bf16 replay failed:\n{res.stdout[-3000:]}\n"
                                 f"{res.stderr[-6000:]}")
        rep = json.loads(res.stdout.strip().splitlines()[-1])
        y = np.load(os.path.join(tmp, "y0.npy"))
        bits = np.array_equal(y.view(np.int32), live.view(np.int32))
        want = {"strips_bf16": 3, "stencil_conv_bf16_io": 3}
        got = {k: v for k, v in {**rep["launches"][0],
                                 **rep["bf16_launches"][0]}.items() if v}
        if not bits or got != want or rep["op_counts"] != {
                "strips": 3, "stencil_conv": 3}:
            raise AssertionError(f"bf16 replay: bitwise {bits}, launches "
                                 f"{got}, ops {rep['op_counts']}")
        paths["bf16_export"] = got
        say("bf16", f"(c) quick_start exported under bfloat16_io in "
            f"{export_s:.2f} s ({nbytes} bytes), replayed by a fresh process: "
            f"logits bitwise equal to the live model, launches {got}, graph "
            f"ops {rep['op_counts']}, {rep['fwd_ms']:.3f} ms a replayed "
            f"forward on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del sm, qs
    torch.cuda.empty_cache()

    # (d) radius 3: phase 9(a)'s one-shot k=40 conv (nside 256, K=5, 4 -> 4,
    # batch 4) in each mode, where the float32 bytes of K1, K2 and K3 do
    # not fit their 2-byte plans' tiles, so they hold 2-byte elements
    # (counted apart, "_s2"): the raw kernels against their plain versions
    # and apart from the float32 kernels on the same values, and the conv's
    # forward and its train step on each route against the float32 conv
    n, k40, K = K40_GRAPH
    B, Fin, Fout = 4, 4, 4
    st = build_sphere_graph(n, k=k40, method="grid", cache_dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".bench_cache")
    ).deep_stencil(0.75, K)
    h, r, npl = st.n_steps, st.radius, len(st.offsets)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fs._k1_plan(n, h, r, npl, K, B, 12, Fin, Fout, sms, 2)
    staged = [fs._k1_bf16_staging(plan, h, r, npl, K)] + [
        fs._bwd_bf16_staging(fs._bwd_plan(n, h, r, npl, K, B, 12, Crec, Cch,
                                          dx, sms, 2), h, r, npl, K, Crec, dx)
        for Crec, Cch, dx in ((Fout, Fin, True), (Fin, Fout, False))]
    if (r, h) != (3, 12) or staged != [2, 2, 2]:
        raise AssertionError(f"radius-3 conv: radius {r}, h {h}, K1 plan "
                             f"{plan}, stagings {staged}")
    kernels_case(f"radius 3 nside={n} B={B} Fin={Fin} Fout={Fout} K={K}", st,
                 B, Fin, Fout, K, strips=False)
    tables = as_tensors(stencil_tables(st, bf16_io=True), dev)
    _, P_l = fs.cfp_geometry(n, h)
    x32 = torch.from_numpy(
        rng.normal(size=(B * Fin, 12, n, P_l)).astype(np.float32)).to(dev)
    kernel = torch.from_numpy((rng.normal(size=(Fin * K, Fout))
                               / np.sqrt(Fin * K)).astype(np.float32)).to(dev)
    cot = torch.from_numpy(
        rng.normal(size=(B * Fout, 12, n, P_l)).astype(np.float32)).to(dev)
    inner = slice(h, h + n)
    xl = x32.clone().requires_grad_()
    kl = kernel.clone().requires_grad_()

    def conv_step():
        y = fs.fused_stencil_conv_cfp(st, tables, xl, kl, K, "cheby", B)
        return (y,) + torch.autograd.grad(y, (xl, kl), cot.to(y.dtype))

    with torch.no_grad():
        y32 = fs.fused_stencil_conv_cfp(st, tables, x32, kernel, K, "cheby", B)
    _, dx32, dk32 = conv_step()
    paths["bf16_radius3"] = {}
    line = []
    for mode in BF_MODES:
        io = mode == "bfloat16_io"
        sfx = ("_bf16_io" if io else "_bf16") + "_s2"
        sk = "strips" + ("_bf16" if io else "")
        config.set_conv_dtype(mode)
        try:
            with torch.no_grad():
                before = counts()
                y = fs.fused_stencil_conv_cfp(st, tables, x32, kernel, K,
                                              "cheby", B)
                torch.cuda.synchronize()
                got = [since(before, paths["bf16_radius3"])]
            errs = [check(f"radius 3 conv {mode} y", y[..., inner],
                          y32[..., inner], BF_F32_TOL)[0]]
            bf16_apart(f"radius 3 conv {mode} y", y[..., inner],
                       y32[..., inner])
            for fused_dw in (True, False):
                config.set_fused_dw(fused_dw)
                before = counts()
                _, dx, dk = conv_step()
                torch.cuda.synchronize()
                got.append(since(before, paths["bf16_radius3"]))
                for what, a, b in (("dx", dx[..., inner], dx32[..., inner]),
                                   ("dW", dk, dk32)):
                    tag = f"radius 3 conv {mode} fused_dw={fused_dw} {what}"
                    errs.append(check(tag, a, b, BF_F32_TOL)[0])
                    bf16_apart(tag, a, b)
        finally:
            config.set_fused_dw(True)
            config.set_conv_dtype("float32")
        # the forward; a train step on the K2 route (the forward, dy's
        # strips, K2) and on the K1+K3 route (the forward, dy's strips, K1
        # on dy, K3)
        want = [{sk: 1, "stencil_conv" + sfx: 1},
                {sk: 2, "stencil_conv" + sfx: 1, "dxdw" + sfx: 1},
                {sk: 2, "stencil_conv" + sfx: 2, "grad" + sfx: 1}]
        if got != want:
            raise AssertionError(f"radius 3 conv {mode}: launches {got}")
        line.append(f"{mode}: y, dx, dW (K2 route), dx, dW (K1+K3 route) rel "
                    f"{', '.join(f'{e:.2e}' for e in errs)} from f32, "
                    f"launches {got}")
        del y, dx, dk
    say("bf16", f"(d) radius-3 conv nside {n} K={K} h={h} {Fin} -> {Fout} B="
        f"{B}, 2-byte plan T={plan.T} G={plan.G}: " + "; ".join(line)
        + f" on {card}")
    del tables, x32, y32, xl, kl, cot, dx32, dk32
    torch.cuda.empty_cache()
    say("bf16", f"phase 15 done in {time.perf_counter() - t_phase:.1f} s")
    return paths


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deepsphere_tpu_torch as dt
    from deepsphere_tpu_torch import config
    from deepsphere_tpu_torch.graph import build_sphere_graph
    from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
    from deepsphere_tpu_torch.ops import _cuda
    from deepsphere_tpu_torch.ops import fused_stencil as fs
    from deepsphere_tpu_torch.ops.stencil import (
        as_tensors,
        cface_embed,
        cface_extract,
        pack_edge_bands,
        pack_edge_bands_plain,
        stencil_graph_conv,
        stencil_tables,
        unpack_edge_bands,
    )
    from deepsphere_tpu_torch.ops.strips import (
        build_band_strips,
        build_strips,
        strip_arrays,
        strip_index_map,
    )
    from deepsphere_tpu_torch.parallel import (
        ShardConfig,
        batch_sharding,
        data_iterator,
        face_shard_tables,
        face_sharded_cfp_conv,
        make_mesh,
    )
    from deepsphere_tpu_torch.train.losses import resolve_loss
    import torch.distributed as dist

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say("card", f"{card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | capability {torch.cuda.get_device_capability(0)}")

    # 2. build (the headline graph builds beside it and phases 3-5, so that
    # phase 3 runs the headline shape after phase 5; phase 9's k=40 graph
    # beside it and phases 3-8)
    root = os.path.dirname(os.path.abspath(__file__))
    prebuild_h = prebuild_headline(root)
    atexit.register(lambda: (prebuild_h.kill(), prebuild_h.wait()))
    prebuild = prebuild_k40(os.path.dirname(os.path.abspath(__file__)))
    atexit.register(lambda: (prebuild.kill(), prebuild.wait()))
    prebuild_s = prebuild_smoothing(os.path.dirname(os.path.abspath(__file__)))
    atexit.register(lambda: (prebuild_s.kill(), prebuild_s.wait()))
    path, secs, log = _cuda.build()
    _cuda.lib()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say("build", f"{secs:.2f} s -> {os.path.basename(path)}")
    for ln in ptxas:
        print("    " + ln)

    rng = np.random.RandomState(1234)
    # kernel -> rows (label, max_abs_err, ms, plain_ms, bound_ms, bound_by,
    # library_ms)
    results = {"strips": [], "stencil_conv": [], "dxdw": [], "grad": []}

    def conv_case(label, st, B, Fin, Fout, K):
        """Phase-3 checks and times of the four kernels at one conv shape."""
        n, h = st.nside, st.n_steps
        R, P_l = fs.cfp_geometry(n, h)
        tables = as_tensors(stencil_tables(st), dev)
        mask = tables.get("corr_mask")
        # garbage in the halo lanes too: no path may read them
        xc = torch.from_numpy(
            rng.normal(size=(B * Fin, 12, n, P_l)).astype(np.float32)).to(dev)
        dy = torch.from_numpy(
            rng.normal(size=(B * Fout, 12, n, P_l)).astype(np.float32)).to(dev)
        kernel = torch.from_numpy(
            (rng.normal(size=(Fin * K, Fout)) / np.sqrt(Fin * K)).astype(np.float32)
        ).to(dev)
        wk3 = kernel.reshape(Fin, K, Fout).permute(1, 0, 2).contiguous()
        wk3t = kernel.reshape(Fin, K, Fout).permute(1, 2, 0).contiguous()
        idx = tables["strip_idx"]
        w = tables["weights"]
        # bytes of C channels' interior lanes: outputs count only these, as
        # nothing downstream reads the zeroed pad lanes
        interior = lambda C: C * 12 * n * n * 4
        cells = 2 * K * Fin * Fout * B * 12 * n * n  # one contraction

        # K4: strips
        got = build_strips(st, xc, idx)
        want = strip_arrays(st, xc)
        for nm, g, wnt in zip(("top", "bot", "ls"), got, want):
            if not torch.equal(g, wnt):
                raise AssertionError(f"{label}: strip {nm} differs from the "
                                     "plain version")
        # device times by graph replay: an eager call of K4 or of
        # index_select costs the host more than the card
        ms_k4 = graph_ms(lambda: build_strips(st, xc, idx))
        ms_k4p = cuda_ms(lambda: strip_arrays(st, xc), iters=3, warmup=1)
        # the same gather as one PyTorch call: index_select along the flat
        # map with -1 pointing at an appended zero column
        slab = 12 * n * P_l
        xz = torch.cat([xc.reshape(B * Fin, slab),
                        xc.new_zeros((B * Fin, 1))], dim=1)
        sel = torch.where(idx >= 0, idx, slab).long()
        lib = torch.index_select(xz, 1, sel)
        if not torch.equal(lib, torch.cat([g.reshape(B * Fin, -1) for g in got], 1)):
            raise AssertionError(f"{label}: index_select strips differ")
        ms_k4l = graph_ms(lambda: torch.index_select(xz, 1, sel))
        src = np.unique(strip_index_map(st))
        k4_bytes = (int((src >= 0).sum()) * 4 * B * Fin
                    + B * Fin * (2 * 12 * R * P_l + 12 * n * 128) * 4)
        results["strips"].append((label, 0.0, ms_k4, ms_k4p,
                                  *bound(k4_bytes, 0), ms_k4l))

        # K1: the raw conv, then the corrected conv
        args = (st, "cheby", K, xc, w, want, wk3, B)
        y_k = fs.run_stencil_kernel(*args)
        y_p = fs.run_stencil_plain(*args)
        torch.cuda.synchronize()
        inner = slice(h, h + n)
        raw = rel_err(y_k[..., inner], y_p[..., inner])
        pad_zero = (y_k[..., :h].abs().max().item() == 0.0
                    and y_k[..., h + n:].abs().max().item() == 0.0)
        if not raw <= TOL or not pad_zero:
            raise AssertionError(f"{label}: raw conv rel err {raw:.3e} "
                                 f"(tol {TOL}), pad lanes zero: {pad_zero}")
        conv = (st, tables, xc, kernel, K, "cheby", B)
        with torch.no_grad():
            yc_k = fs.fused_stencil_conv_cfp(*conv)
            yc_p = fs.fused_stencil_conv_cfp_plain(*conv)
        corr = rel_err(yc_k[..., inner], yc_p[..., inner])
        if not corr <= TOL:
            raise AssertionError(f"{label}: corrected conv rel err {corr:.3e}")
        ms_k1 = graph_ms(lambda: fs.run_stencil_kernel(*args))
        ms_k1p = cuda_ms(lambda: fs.run_stencil_plain(*args), iters=3,
                         warmup=1)
        abs_k1 = (y_k[..., inner] - y_p[..., inner]).abs().max().item()
        k1 = k1_bound(st, K, B, Fin, Fout)
        results["stencil_conv"].append((label, abs_k1, ms_k1, ms_k1p, *k1,
                                        None))

        # K2: dx and dW in one pass over dy
        dy_s = strip_arrays(st, dy)
        a2 = (st, "cheby", K, dy, w, dy_s, wk3t, xc, mask, B)
        dx_k, dw_k = fs.run_dxdw_kernel(*a2)
        _, dw_k2 = fs.run_dxdw_kernel(*a2)
        dx_p, dw_p = fs.run_dxdw_plain(*a2)
        torch.cuda.synchronize()
        e_dx = rel_err(dx_k[..., inner], dx_p[..., inner])
        e_dw2 = rel_err(dw_k, dw_p)
        pad_zero = (dx_k[..., :h].abs().max().item() == 0.0
                    and dx_k[..., h + n:].abs().max().item() == 0.0)
        if not (e_dx <= TOL and e_dw2 <= DW_TOL and pad_zero
                and torch.equal(dw_k, dw_k2)):
            raise AssertionError(
                f"{label}: K2 dx rel {e_dx:.3e} dW rel {e_dw2:.3e} pad zero "
                f"{pad_zero} dW repeatable {torch.equal(dw_k, dw_k2)}")
        ms_k2 = graph_ms(lambda: fs.run_dxdw_kernel(*a2))
        ms_k2p = cuda_ms(lambda: fs.run_dxdw_plain(*a2), iters=3, warmup=1)
        abs_k2 = max((dx_k[..., inner] - dx_p[..., inner]).abs().max().item(),
                     (dw_k - dw_p).abs().max().item())
        tb, tf = tile_work(st, K, B * Fout)
        k2 = bound(interior(B * Fout) + tb + wk3t.numel() * 4
                   + interior(B * Fin) + 12 * n * n * 4 + interior(B * Fin)
                   + dw_k.numel() * 4,
                   tf + 2 * cells + B * Fin * 12 * n * n)
        results["dxdw"].append((label, abs_k2, ms_k2, ms_k2p, *k2, None))

        # K3: dW from the recursion on x
        a3 = (st, "cheby", K, xc, w, want, dy, B)
        g_k = fs.run_grad_kernel(*a3)
        g_k2 = fs.run_grad_kernel(*a3)
        g_p = fs.run_grad_plain(*a3)
        torch.cuda.synchronize()
        e_dw3 = rel_err(g_k, g_p)
        if not (e_dw3 <= DW_TOL and torch.equal(g_k, g_k2)):
            raise AssertionError(f"{label}: K3 dW rel {e_dw3:.3e} repeatable "
                                 f"{torch.equal(g_k, g_k2)}")
        ms_k3 = graph_ms(lambda: fs.run_grad_kernel(*a3))
        ms_k3p = cuda_ms(lambda: fs.run_grad_plain(*a3), iters=3, warmup=1)
        tb, tf = tile_work(st, K, B * Fin)
        k3 = bound(interior(B * Fin) + tb + interior(B * Fout)
                   + g_k.numel() * 4, tf + cells)
        results["grad"].append((label, (g_k - g_p).abs().max().item(), ms_k3,
                                ms_k3p, *k3, None))

        say("kernels", f"{label}: K4 strips exact {ms_k4:.4f} ms (plain "
            f"{ms_k4p:.4f}, index_select {ms_k4l:.4f}, bound "
            f"{results['strips'][-1][4]:.4f}) | K1 raw rel {raw:.2e} "
            f"{ms_k1:.4f} ms (plain {ms_k1p:.4f}, bound {k1[0]:.4f} "
            f"{k1[1]}) corrected rel {corr:.2e} | K2 dx rel {e_dx:.2e} dW rel "
            f"{e_dw2:.2e} {ms_k2:.4f} ms (plain {ms_k2p:.4f}, bound "
            f"{k2[0]:.4f} {k2[1]}) | K3 dW rel {e_dw3:.2e} {ms_k3:.4f} ms "
            f"(plain {ms_k3p:.4f}, bound {k3[0]:.4f} {k3[1]}) | dW "
            "bitwise-repeatable")

    # 3. kernels against their plain versions
    qs_convs = [(64, 1, 8), (32, 8, 16), (16, 16, 32)]  # (nside, Fin, Fout)
    qs_graph_s = time.perf_counter()
    qs_st = {}
    for n, Fin, Fout in qs_convs:
        g = build_sphere_graph(n, k=8, method="grid")
        qs_st[n] = g.deep_stencil(0.75, 10)
    qs_graph_s = time.perf_counter() - qs_graph_s
    for n, Fin, Fout in qs_convs:
        conv_case(f"quick_start nside={n} B=16 Fin={Fin} Fout={Fout} K=10",
                  qs_st[n], 16, Fin, Fout, 10)

    # 4. serving: the quick_start classifier at nside 64
    nside = 64
    npix = 12 * nside * nside

    t = time.perf_counter()
    model = serving_model(dt, hp_nn)
    cface_convs = [(key, layer._stencil())
                   for key, layer in model.layers.items()
                   if getattr(layer, "layout", None) == "cface"
                   and hasattr(layer, "graph")]
    if next(model.parameters()).device.type != "cuda":
        raise AssertionError("build did not place the model on the card")
    plan = [type(m).__name__ for m in model.layers.values()]
    # the reference: a float64 copy on the CPU planned in NEST (its convs
    # per step: 0.6 s for a request on an 8-core CPU against 28 s for the
    # cface plain versions in float32)
    cpu_model = nest_reference(dt, model, nside, quick_start_layers(hp_nn))
    cpu_model.eval()
    say("serving", f"model built on the card in {time.perf_counter() - t:.2f}"
        f" s; plan {plan}")
    for key, st in cface_convs:
        rows = int(np.asarray(st.corr_out_face).shape[0])
        say("serving", f"{key}: nside {st.nside} h={st.n_steps}: correction "
            f"recomputes {rows} of {12 * st.nside ** 2} rows "
            f"({rows / (12 * st.nside ** 2):.1%})")

    x = rng.normal(size=(4 * 16, npix, 1)).astype(np.float32)
    _cuda.reset_launch_counts()
    logits = model.predict(x, batch_size=16)  # 4 requests of 16 maps
    torch.cuda.synchronize()
    launches = dict(_cuda.launch_counts)
    n_fwd = 4
    want = {"strips": 3 * n_fwd, "stencil_conv": 3 * n_fwd, "dxdw": 0,
            "grad": 0, "bands": 0}
    if launches != want or _cuda.route_counts["per_step_cface"]:
        raise AssertionError(f"serving launched {launches} in {n_fwd} "
                             f"forwards, expected {want}, and took the "
                             f"routes {_cuda.route_counts}")
    if logits.shape != (64, 4) or not np.all(np.isfinite(logits)):
        raise AssertionError(f"bad logits: shape {logits.shape}")
    t = time.perf_counter()
    with torch.no_grad():  # 1 request on the CPU
        ref = cpu_model(torch.from_numpy(x[:16].astype(np.float64))).numpy()
    cpu_s = time.perf_counter() - t
    rel = float(np.abs(logits[:16] - ref).max() / np.abs(ref).max())
    if not rel <= 1e-4:
        raise AssertionError(f"card logits differ from the CPU by rel {rel:.3e}")
    xb = torch.from_numpy(x[:16]).to(dev)
    model.eval()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(xb), iters=20, warmup=3)
    say("serving", f"4 requests x 16 maps: logits {logits.shape}, finite, "
        f"launches {launches}; max rel vs CPU {rel:.2e} over 1 request (CPU "
        f"took {cpu_s:.1f} s); {fwd_ms:.3f} ms per forward of 16 maps "
        f"({16e3 / fwd_ms:.1f} maps/s) on {card}")
    serve_ms = fwd_ms
    del model, cpu_model

    # 5. training: the quick_start classifier at nside 64, batch 16
    loss_name = "sparse_categorical_crossentropy_from_logits"
    t = time.perf_counter()
    model = dt.HealpyGCNN(nside=nside, indices=np.arange(npix),
                          layers=quick_start_layers(hp_nn))
    model.build((16, npix, 1), seed=11)
    init = copy.deepcopy(model)  # the starting point of every route
    data = np.random.RandomState(12)
    xt = data.normal(size=(64, npix, 1)).astype(np.float32)
    yt = data.randint(0, 4, size=64)
    say("train", f"model built in {time.perf_counter() - t:.2f} s")

    # the reference is a float64 copy on the CPU, planned in NEST (its
    # convs per step: the same model by another route, 1.8 s a step on an
    # 8-core host against 49 s for the cface plain versions).  A conv
    # followed by batch norm (no affine) gives the same loss for any scale
    # of its kernel, so its gradient is orthogonal to the kernel: a
    # cancellation, which float32 rounding in any order disturbs at ~1e-3
    # of its max (a float32 CPU step read 2.21e-3 from float64 on the same
    # batch).  The card is held to float64 at fixed limits.
    cpu64 = nest_reference(dt, model, nside, quick_start_layers(hp_nn))
    t = time.perf_counter()
    cpu64.train()
    out64 = cpu64(torch.from_numpy(xt[:16].astype(np.float64)))
    loss64 = resolve_loss(loss_name)(torch.from_numpy(yt[:16]), out64)
    loss64.backward()
    loss64 = float(loss64.detach())
    g64, s64 = grads_of(cpu64), stats_of(cpu64)
    cpu_s = time.perf_counter() - t
    del cpu64, out64

    # the main path of this slice, counted from 0: one step on each route
    route_want = {
        True: {"strips": 6, "stencil_conv": 3, "dxdw": 3, "grad": 0,
               "bands": 0},
        # conv 1's input needs no gradient, so its dx conv is skipped
        False: {"strips": 5, "stencil_conv": 5, "dxdw": 0, "grad": 3,
                "bands": 0},
    }
    train_launches = {k: 0 for k in _cuda.launch_counts}
    routes = {}
    for fused in (True, False):
        config.set_fused_dw(fused)
        m = copy.deepcopy(init)
        m.compile(optimizer=1e-3, loss=loss_name, metrics=["accuracy"])
        _cuda.reset_launch_counts()
        logs = m._trainer.train_on_batch(xt[:16], yt[:16])
        torch.cuda.synchronize()
        counts = dict(_cuda.launch_counts)
        for k, v in counts.items():
            train_launches[k] += v
        if counts != route_want[fused] or _cuda.route_counts["per_step_cface"]:
            raise AssertionError(f"fused_dw={fused}: one train step launched "
                                 f"{counts}, expected {route_want[fused]}, "
                                 f"and took the routes {_cuda.route_counts}")
        g, st_ = grads_of(m), stats_of(m)
        loss_rel = abs(logs["loss"] - loss64) / abs(loss64)
        g_err, s_err = tree_errs(g, g64), tree_errs(st_, s64)
        bad = {**held(g_err, GRAD_TOL), **held(s_err, BN_TOL)}
        if not (np.isfinite(logs["loss"]) and loss_rel <= 1e-5) or bad:
            raise AssertionError(
                f"fused_dw={fused}: loss rel {loss_rel:.3e} against float64; "
                f"errors against float64 above {GRAD_TOL} (gradients) or "
                f"{BN_TOL} (BN): {bad}")
        routes[fused] = (m, g, logs, loss_rel, max(g_err.values()),
                         max(s_err.values()), counts)
    route_err = max(tree_errs(routes[False][1], routes[True][1]).values())
    say("train", f"one train_on_batch of 16 maps: float64 CPU loss "
        f"{loss64:.6f} (step {cpu_s:.1f} s); K2 route: loss rel "
        f"{routes[True][3]:.2e}"
        f", gradients {routes[True][4]:.2e}, BN {routes[True][5]:.2e}, "
        f"launches {routes[True][6]}; K1+K3 route: loss rel "
        f"{routes[False][3]:.2e}, gradients {routes[False][4]:.2e}, BN "
        f"{routes[False][5]:.2e}, launches {routes[False][6]}; the routes "
        f"differ by {route_err:.2e}")

    config.set_fused_dw(True)
    m = routes[True][0]
    _cuda.reset_launch_counts()
    hist = m.fit(xt, yt, batch_size=16, epochs=2, verbose=0)
    torch.cuda.synchronize()
    fit_counts = dict(_cuda.launch_counts)
    for k, v in fit_counts.items():
        train_launches[k] += v
    if not (len(hist["loss"]) == 2
            and all(np.isfinite(v) for v in hist["loss"] + hist["accuracy"])):
        raise AssertionError(f"fit history {hist}")
    if fit_counts != {k: 8 * v for k, v in route_want[True].items()}:
        raise AssertionError(f"fit over 8 steps launched {fit_counts}")
    missing = [k for k in ("strips", "stencil_conv", "dxdw", "grad")
               if train_launches[k] == 0]
    if missing:
        raise AssertionError(f"the training path never launched {missing}")

    step_ms, _ = time_routes(config, {f: routes[f][0]._trainer
                                      for f in (True, False)}, xt, yt)
    # where a step's time goes: kernels on the card over 3 steps
    tr = routes[True][0]._trainer
    n_dev, busy, top, _ = device_profile(
        lambda i: tr.train_on_batch(xt[16 * i:16 * i + 16],
                                    yt[16 * i:16 * i + 16]), 3, top=6)
    if n_dev == 0:
        raise AssertionError("the profiler saw no device work in 3 steps")
    say("train", f"profile of the K2-route step: {n_dev:.0f} device ops, "
        f"{busy:.3f} ms device-busy per step = {busy / step_ms[True]:.1%} of "
        f"the unprofiled {step_ms[True]:.3f} ms; top by device time per step: "
        + "; ".join(f"{nm[:60]} x{c:.0f} {t:.3f} ms" for nm, c, t in top))
    say("train", f"fit 2 epochs x 64 maps: loss {hist['loss']}, accuracy "
        f"{hist['accuracy']}, launches {fit_counts}; ms per train step of 16 "
        f"maps (host clock, synchronized, median of 10 with the routes "
        f"alternating, after 3 warm-up steps each): K2 "
        f"route {step_ms[True]:.3f} ({16e3 / step_ms[True]:.1f} maps/s), "
        f"K1+K3 route {step_ms[False]:.3f} ({16e3 / step_ms[False]:.1f} "
        f"maps/s) on {card}")
    del routes, m  # phase 7 starts from ``init`` too

    # 3, the headline shape: its graph builds beside phases 2-5
    t = time.perf_counter()
    if prebuild_h.wait() != 0:
        raise AssertionError("the headline graph's side build failed")
    waited = time.perf_counter() - t
    g1024 = build_sphere_graph(1024, k=8, method="grid",
                               cache_dir=os.path.join(root, ".bench_cache"))
    st1024 = g1024.deep_stencil(0.75, 5)
    head_graph_s = time.perf_counter() - t
    say("kernels", f"headline graph + stencil built beside phases 2-5 (waited "
        f"{waited:.2f} s for it, loaded in {head_graph_s - waited:.2f} s)")
    conv_case("headline nside=1024 B=4 Fin=4 Fout=4 K=5", st1024, 4, 4, 4, 5)

    # 6. headline conv: kernels vs the plain per-step path, both on the card
    B, Fin, Fout, K = 4, 4, 4, 5
    n, h = 1024, st1024.n_steps
    tables = as_tensors(stencil_tables(st1024), dev)
    M = 12 * n * n
    xf = torch.from_numpy(rng.normal(size=(B, M, Fin)).astype(np.float32)).to(dev)
    kernel = torch.from_numpy(
        (rng.normal(size=(Fin * K, Fout)) / np.sqrt(Fin * K)).astype(np.float32)
    ).to(dev)
    xc = cface_embed(xf, n, h).reshape(B * Fin, 12, n, -1).contiguous()
    gb = xc.numel() * 4 / 1e9
    with torch.inference_mode():
        fused = lambda: fs.fused_stencil_conv_cfp(st1024, tables, xc, kernel,
                                                  K, "cheby", B)
        step = lambda: stencil_graph_conv(st1024, xf, kernel, K, "cheby",
                                          tables=tables, layout="face")
        y_f = fused().reshape(B, Fout, 12, n, -1)[..., h:h + n]
        y_f = y_f.reshape(B, Fout, M).permute(0, 2, 1)
        y_s = step()
        head_rel = rel_err(y_f, y_s)
        if not head_rel <= TOL:
            raise AssertionError(f"headline conv rel err {head_rel:.3e}")
        ms_step1 = cuda_ms(step, iters=5, warmup=1)
        ms_fused1 = cuda_ms(fused, iters=10, warmup=2)
        ms_fused2 = cuda_ms(fused, iters=10, warmup=2)
        ms_step2 = cuda_ms(step, iters=5, warmup=1)
    ms_fused = (ms_fused1 + ms_fused2) / 2
    ms_step = (ms_step1 + ms_step2) / 2
    say("headline", f"nside {n} K={K} Fin=Fout={Fin} B={B} ({gb:.2f} GB "
        f"activation): rel err vs per-step {head_rel:.2e}; fused kernels "
        f"{ms_fused:.3f} ms ({B * 1e3 / ms_fused:.1f} maps/s) [{ms_fused1:.3f}, "
        f"{ms_fused2:.3f}], per-step plain {ms_step:.3f} ms "
        f"({B * 1e3 / ms_step:.1f} maps/s) [{ms_step1:.3f}, {ms_step2:.3f}]; "
        f"graph + stencil build {head_graph_s:.2f} s (quick_start graphs "
        f"{qs_graph_s:.2f} s) on {card}")

    # the headline train step: forward + backward with a fixed cotangent
    cot = torch.from_numpy(
        rng.normal(size=(B, M, Fout)).astype(np.float32)).to(dev)
    xl = xf.clone().requires_grad_()
    kl = kernel.clone().requires_grad_()

    def fused_step():
        xc_ = cface_embed(xl, n, h).reshape(B * Fin, 12, n, -1)
        y = fs.fused_stencil_conv_cfp(st1024, tables, xc_, kl, K, "cheby", B)
        yi = cface_extract(y.reshape(B, Fout, 12, n, -1), h)
        return torch.autograd.grad(yi, (xl, kl), cot)

    def plain_step():
        y = stencil_graph_conv(st1024, xl, kl, K, "cheby", tables=tables,
                               layout="face")
        return torch.autograd.grad(y, (xl, kl), cot)

    dx_s, dk_s = plain_step()
    train_ms = {}
    for fused_dw in (True, False):
        config.set_fused_dw(fused_dw)
        dx_f, dk_f = fused_step()
        e_dx, e_dk = rel_err(dx_f, dx_s), rel_err(dk_f, dk_s)
        if not (e_dx <= TOL and e_dk <= DW_TOL):
            raise AssertionError(f"headline train step fused_dw={fused_dw}: "
                                 f"dx rel {e_dx:.3e}, dW rel {e_dk:.3e}")
        train_ms[fused_dw] = (cuda_ms(fused_step, iters=5, warmup=1), e_dx,
                              e_dk)
    config.set_fused_dw(True)
    ms_plain_train = cuda_ms(plain_step, iters=3, warmup=1)
    del dx_s, dk_s
    say("headline", f"train step (fwd + bwd, fixed cotangent): K2 route "
        f"{train_ms[True][0]:.3f} ms (dx rel {train_ms[True][1]:.2e}, dW rel "
        f"{train_ms[True][2]:.2e}), K1+K3 route {train_ms[False][0]:.3f} ms "
        f"(dx rel {train_ms[False][1]:.2e}, dW rel {train_ms[False][2]:.2e}), "
        f"per-step plain autograd {ms_plain_train:.3f} ms on {card}")

    # 7. sharded: the DP x face-sharded path on a 1 x 1 mesh (one NCCL rank)
    results["bands"] = []
    gen = torch.Generator(device=dev).manual_seed(77)

    def bands_case(label, n, h, C, F):
        """(a) K5 against its plain version (exact) and index_select."""
        _, P = fs.cfp_geometry(n, h)
        xc = torch.randn((C, F, n, P), generator=gen, device=dev)
        got = pack_edge_bands(xc, n, h)
        if not torch.equal(got, pack_edge_bands_plain(xc, n, h)):
            raise AssertionError(f"{label}: K5 differs from the plain version")
        flat, idx = xc.reshape(-1), band_map(C, F, n, h, P, dev)
        if not torch.equal(torch.index_select(flat, 0, idx), got.reshape(-1)):
            raise AssertionError(f"{label}: index_select bands differ")
        # device times (graph replay: the eager call is host-bound here), K5
        # and index_select in turns: K5, index_select, index_select, K5, ...
        fns = {"k5": lambda: pack_edge_bands(xc, n, h),
               "lib": lambda: torch.index_select(flat, 0, idx)}
        turns = {"k5": [], "lib": []}
        for i in range(4):
            for who in (("k5", "lib") if i % 2 == 0 else ("lib", "k5")):
                turns[who].append(graph_ms(fns[who]))
        ms, ms_l = (float(np.median(turns[w])) for w in ("k5", "lib"))
        ratios = [a / b for a, b in zip(turns["k5"], turns["lib"])]
        ms_p = graph_ms(lambda: pack_edge_bands_plain(xc, n, h))
        eager = cuda_ms(lambda: pack_edge_bands(xc, n, h), iters=20, warmup=3)
        # the least the card must move: each distinct interior source element
        # once (the four bands cover all but the inner (n - 2h)^2) and the
        # output once
        src = (n * n - max(n - 2 * h, 0) ** 2) * C * F
        b = bound((src + got.numel()) * 4, 0)
        results["bands"].append((label, 0.0, ms, ms_p, *b, ms_l))
        say("sharded", f"{label}: K5 exact, {ms:.4f} ms on the device, "
            f"{b[0] / ms:.0%} of its bound {b[0]:.4f} ms ({b[1]}; "
            f"{src * 4 / 1e6:.2f} MB in, {got.numel() * 4 / 1e6:.2f} MB out); "
            f"index_select {ms_l:.4f} ms; in turns K5 {turns['k5']} ms, "
            f"index_select {turns['lib']} ms, K5 / index_select "
            f"{min(ratios):.3f}-{max(ratios):.3f}; plain {ms_p:.4f} ms; "
            f"{eager:.4f} ms per eager call")

    def dataflow(label, st, C, S=4):
        """(b) K5 on S face slices, the buffers concatenated (what the
        all-gather returns), each shard's strips from them: exactly the
        unsharded K4 strips' slices and the plain band strips."""
        n, h = st.nside, st.n_steps
        _, P = fs.cfp_geometry(n, h)
        xc = torch.randn((C, 12, n, P), generator=gen, device=dev)
        F = 12 // S
        bands = torch.cat([pack_edge_bands(xc[:, s * F:(s + 1) * F]
                                           .contiguous(), n, h)
                           for s in range(S)])
        full = build_strips(st, xc)
        for s in range(S):
            faces = range(s * F, (s + 1) * F)
            got = build_band_strips(st, bands, faces)
            plain = strip_arrays(st, None, faces, unpack_edge_bands(bands, n, h))
            for nm, g, f, p_ in zip(("top", "bot", "ls"), got, full, plain):
                if not (torch.equal(g, f[:, s * F:(s + 1) * F])
                        and torch.equal(g, p_)):
                    raise AssertionError(f"{label}: shard {s} strip {nm} "
                                         "differs")
        say("sharded", f"{label}: {S} shards' strips from the gathered bands "
            "equal the unsharded strips and the plain band strips")

    qs_bands = [(64, 16), (32, 128), (16, 256)]  # (nside, B*Fin), h = 9
    for F in (12, 3):
        for n, C in qs_bands:
            pre = "quick_start" if F == 12 else "face shard of 3:"
            bands_case(f"{pre} nside={n} C={C} h=9 F_loc={F}", n, 9, C, F)
    bands_case("headline nside=1024 C=16 h=4 F_loc=12", 1024, 4, 16, 12)
    for n, C in qs_bands:
        dataflow(f"quick_start nside={n} C={C}", qs_st[n], C)
    dataflow("headline nside=1024 C=16", st1024, 16)

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "pixel"))
        cfg = ShardConfig(mesh)

        # (c) the sharded conv at the headline against the unsharded conv
        # on the K1 + K3 route
        B, Fin, Fout, K = 4, 4, 4, 5
        n, h = 1024, st1024.n_steps
        inner = slice(h, h + n)
        tab_sh = as_tensors(face_shard_tables(st1024, 0, 1), dev)
        _, P = fs.cfp_geometry(n, h)
        xc = torch.randn((B * Fin, 12, n, P), generator=gen, device=dev)
        cot = torch.randn((B * Fout, 12, n, P), generator=gen, device=dev)
        kernel = (torch.randn((Fin * K, Fout), generator=gen, device=dev)
                  / np.sqrt(Fin * K))
        xl = xc.clone().requires_grad_()
        kl = kernel.clone().requires_grad_()
        sharded = lambda a, k: face_sharded_cfp_conv(
            st1024, tab_sh, a, k, K, "cheby", B, cfg.pixel_group)
        unsharded = lambda a, k: fs.fused_stencil_conv_cfp(
            st1024, tables, a, k, K, "cheby", B)
        config.set_fused_dw(False)
        with torch.no_grad():
            y_s, y_u = sharded(xc, kernel), unsharded(xc, kernel)
        e_y = rel_err(y_s[..., inner], y_u[..., inner])
        step_s = lambda: torch.autograd.grad(sharded(xl, kl), (xl, kl), cot)
        step_u = lambda: torch.autograd.grad(unsharded(xl, kl), (xl, kl), cot)
        (dx_s, dk_s), (dx_u, dk_u) = step_s(), step_u()
        e_dx = rel_err(dx_s[..., inner], dx_u[..., inner])
        e_dk = rel_err(dk_s, dk_u)
        if not (e_y <= TOL and e_dx <= TOL and e_dk <= DW_TOL):
            raise AssertionError(f"sharded headline conv: y rel {e_y:.3e}, dx "
                                 f"rel {e_dx:.3e}, dW rel {e_dk:.3e}")
        with torch.no_grad():
            ms_fs = cuda_ms(lambda: sharded(xc, kernel), iters=5, warmup=1)
            ms_fu = cuda_ms(lambda: unsharded(xc, kernel), iters=5, warmup=1)
            # the forwards' device time apart from the host's
            fwd_prof = {w: device_profile(lambda i, f=f: f(xc, kernel), 5,
                                          top=5)
                        for w, f in (("sharded", sharded),
                                     ("unsharded", unsharded))}
        ms_ts = cuda_ms(step_s, iters=5, warmup=1)
        ms_tu = cuda_ms(step_u, iters=5, warmup=1)
        config.set_fused_dw(True)
        say("sharded", f"headline conv nside {n} K={K} B={B} Fin=Fout={Fin} "
            f"on a 1 x 1 mesh: y rel {e_y:.2e}, dx rel {e_dx:.2e}, dW rel "
            f"{e_dk:.2e} against the unsharded K1+K3 route; forward "
            f"{ms_fs:.3f} ms sharded vs {ms_fu:.3f} ms unsharded; fwd + bwd "
            f"{ms_ts:.3f} ms vs {ms_tu:.3f} ms on {card}")
        for w, (ops, busy, top, _) in fwd_prof.items():
            say("sharded", f"profile of the {w} headline forward: {ops:.0f} "
                f"device ops, {busy:.3f} ms device-busy per forward; top: "
                + "; ".join(f"{nm[:60]} x{c:.0f} {t:.4f} ms"
                            for nm, c, t in top))
        del xc, cot, xl, kl, y_s, y_u, dx_s, dk_s, dx_u, dk_u, tab_sh

        # (d) the full-width quick_start classifier trained under the mesh,
        # from phase 5's weights and first batch, so its float64 CPU step
        # is a reference too
        t = time.perf_counter()
        plain = copy.deepcopy(init)
        model = dt.HealpyGCNN(nside=nside, indices=np.arange(npix),
                              layers=quick_start_layers(hp_nn), shard_cfg=cfg)
        model.build((16, npix, 1), seed=11)
        model.load_state_dict(init.state_dict())
        plan = [type(m).__name__ + ("*" if getattr(m, "shard_cfg", None)
                                    is not None else "")
                for m in model.layers.values()]
        say("sharded", f"models built in {time.perf_counter() - t:.2f} s; "
            f"plan (* under the mesh) {plan}")
        config.set_fused_dw(False)
        plain.compile(optimizer=1e-3, loss=loss_name, metrics=["accuracy"])
        logs_u = plain._trainer.train_on_batch(xt[:16], yt[:16])
        g_u, s_u = grads_of(plain), stats_of(plain)
        tr = model.compile(optimizer=1e-3, loss=loss_name,
                           metrics=["accuracy"],
                           data_sharding=batch_sharding(mesh))
        want_step = {"strips": 5, "stencil_conv": 5, "dxdw": 0, "grad": 3,
                     "bands": 5}
        batches = data_iterator(mesh, xt, yt, batch_size=16, shuffle=False)
        _cuda.reset_launch_counts()  # the main path of this slice
        for i in range(3):
            xb, yb = next(batches)
            before = dict(_cuda.launch_counts)
            logs = tr.train_on_batch(xb, yb)
            torch.cuda.synchronize()
            step = {k: v - before[k] for k, v in _cuda.launch_counts.items()}
            if step != want_step:
                raise AssertionError(f"sharded step {i} launched {step}, "
                                     f"expected {want_step}")
            if i == 0:  # against the unsharded card step and float64
                g_s, s_s = grads_of(model), stats_of(model)
                loss_rel = abs(logs["loss"] - logs_u["loss"]) / abs(logs_u["loss"])
                g_err, s_err = tree_errs(g_s, g_u), tree_errs(s_s, s_u)
                loss64_rel = abs(logs["loss"] - loss64) / abs(loss64)
                g64_err, s64_err = tree_errs(g_s, g64), tree_errs(s_s, s64)
                bad = {**held(g_err, GRAD_TOL), **held(s_err, BN_TOL),
                       **held(g64_err, GRAD_TOL), **held(s64_err, BN_TOL)}
                if not (loss_rel <= 1e-5 and loss64_rel <= 1e-5) or bad:
                    raise AssertionError(
                        f"sharded step: loss rel {loss_rel:.3e} (float64: "
                        f"{loss64_rel:.3e}); against the unsharded step "
                        f"{g_err} {s_err}, against float64 {g64_err} "
                        f"{s64_err}; above {GRAD_TOL} / {BN_TOL}: {bad}")
            if not np.isfinite(logs["loss"]):
                raise AssertionError(f"sharded step {i}: loss {logs['loss']}")
        shard_launches = dict(_cuda.launch_counts)
        missing = [k for k in ("bands", "strips", "stencil_conv", "grad")
                   if shard_launches[k] == 0]
        if missing:
            raise AssertionError(f"the sharded path never launched {missing}")
        _cuda.reset_launch_counts()
        model.eval()
        with torch.no_grad():
            model(torch.from_numpy(xt[:16]).to(dev))
        torch.cuda.synchronize()
        fwd_counts = dict(_cuda.launch_counts)
        if fwd_counts["bands"] != 3 or fwd_counts["stencil_conv"] != 3:
            raise AssertionError(f"a sharded forward launched {fwd_counts}")
        model.train()

        trainers = {"sharded": tr, "unsharded": plain._trainer}
        step_of = lambda who: lambda i: trainers[who].train_on_batch(
            xt[16 * (i % 4):16 * (i % 4) + 16], yt[16 * (i % 4):16 * (i % 4) + 16])
        times = {"sharded": [], "unsharded": []}
        for who in ("unsharded", "sharded", "sharded", "unsharded"):
            step_of(who)(0)  # warm-up
            for i in range(4):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step_of(who)(i)
                torch.cuda.synchronize()
                times[who].append((time.perf_counter() - t) * 1e3)
        ms_sh, ms_un = (float(np.mean(times[w])) for w in ("sharded",
                                                          "unsharded"))
        prof = {w: device_profile(step_of(w), 3) for w in times}
        config.set_fused_dw(True)
        say("sharded", f"quick_start nside {nside} batch 16 under the 1 x 1 "
            f"mesh: 3 steps through data_iterator, launches per step "
            f"{want_step} ({shard_launches} in all; a forward {fwd_counts}); "
            f"first step against the unsharded K1+K3 step: loss rel "
            f"{loss_rel:.2e}, gradients {max(g_err.values()):.2e} (per tensor "
            f"{g_err}), BN {max(s_err.values()):.2e}; against the float64 CPU"
            f" step: loss rel {loss64_rel:.2e}, gradients "
            f"{max(g64_err.values()):.2e}, BN {max(s64_err.values()):.2e}; "
            f"ms per step (host clock, synchronized, 8 each in turns "
            f"unsharded, sharded, sharded, unsharded): sharded {ms_sh:.3f} "
            f"({16e3 / ms_sh:.1f} maps/s), unsharded K1+K3 {ms_un:.3f} "
            f"({16e3 / ms_un:.1f} maps/s); profiled per step: sharded "
            f"{prof['sharded'][0]:.0f} device ops, {prof['sharded'][1]:.3f} ms "
            f"device-busy; unsharded {prof['unsharded'][0]:.0f} ops, "
            f"{prof['unsharded'][1]:.3f} ms on {card}")
        del model, plain, tr, init
    finally:
        config.set_fused_dw(True)
        dist.destroy_process_group()

    # 8. the per-step cface route: a k=60 grid graph at K=5 is radius 4 at
    # h=16, where the JAX package runs no kernel and whose weight window
    # alone outgrows a block's shared memory, so K1-K3 have no plan and the
    # unsharded cface conv runs per step
    nside = 32
    npix = 12 * nside * nside
    t = time.perf_counter()
    model = dt.HealpyGCNN(nside, np.arange(npix), [
        hp_nn.HealpyChebyshev(K=5, Fout=8, activation="relu"),
        hp_nn.HealpyPool(p=1), hp_nn.Flatten(), hp_nn.Dense(4)],
        n_neighbors=60)
    model.build((4, npix, 1), seed=21)  # on the card
    cpu = copy.deepcopy(model).to("cpu")
    conv = next(m for m in model.layers.values()
                if getattr(m, "layout", None) == "cface")
    st60 = conv._stencil()
    rt = fs.cface_route(st60, "cheby", 5, 4, 1, 8,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    if rt != "per_step":
        raise AssertionError(f"the k=60 conv took the route {rt}")
    x8 = rng.normal(size=(4, npix, 1)).astype(np.float32)
    y8 = rng.randint(0, 4, size=4)
    _cuda.reset_launch_counts()
    logits = model.predict(x8, batch_size=4)
    torch.cuda.synchronize()
    fwd_counts = (dict(_cuda.launch_counts), dict(_cuda.route_counts))
    ref = cpu.predict(x8, batch_size=4)
    rel = float(np.abs(logits - ref).max() / np.abs(ref).max())
    for m in (model, cpu):
        m.compile(optimizer=1e-3, loss=loss_name)
    _cuda.reset_launch_counts()
    logs = model._trainer.train_on_batch(x8, y8)
    torch.cuda.synchronize()
    step_counts = (dict(_cuda.launch_counts), dict(_cuda.route_counts))
    logs_c = cpu._trainer.train_on_batch(x8, y8)
    loss_rel = abs(logs["loss"] - logs_c["loss"]) / abs(logs_c["loss"])
    g_err = tree_errs(grads_of(model), grads_of(cpu))
    none = {k: 0 for k in _cuda.launch_counts}
    per_step_once = {"per_step_cface": 1, "chain_cface": 0, "lap_chain": 0,
                     "smooth_fused": 0, "smooth_per_step": 0}
    if (fwd_counts != (none, per_step_once)
            or step_counts != (none, per_step_once)):
        raise AssertionError(f"the k=60 model: a forward counted {fwd_counts}"
                             f", a train step {step_counts}")
    if not (logits.shape == (4, 4) and rel <= 1e-4 and loss_rel <= 1e-5
            and not held(g_err, 1e-4)):
        raise AssertionError(f"the k=60 model against the CPU: logits "
                             f"{logits.shape} rel {rel:.3e}, loss rel "
                             f"{loss_rel:.3e}, gradients {g_err}")
    xb = torch.from_numpy(x8).to(dev)
    model.eval()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(xb), iters=10, warmup=2)
    say("per-step", f"k=60 grid graph, Chebyshev K=5 (radius {st60.radius}, "
        f"h={st60.n_steps}), nside {nside}, batch 4, 1 -> 8 channels "
        f"({time.perf_counter() - t:.2f} s with the CPU references): route "
        f"{rt}; a forward counted "
        f"{fwd_counts[1]} and launched {fwd_counts[0]}, a train step "
        f"{step_counts[1]} and {step_counts[0]}; against the CPU: logits rel "
        f"{rel:.2e}, loss rel {loss_rel:.2e}, gradients "
        f"{max(g_err.values()):.2e}; {fwd_ms:.3f} ms per forward of 4 maps on "
        f"{card}")
    del model, cpu

    # 9-10. the lap chain and the conv family
    path_launches, chain_times, family = chain_and_family(dev, card, rng,
                                                          prebuild)
    # 11-12. smoothing, and the kitchen-sink network with both attentions
    more_paths, slice_times = smoothing_and_attention(dev, card, rng,
                                                      prebuild_s)
    path_launches.update(more_paths)
    # 13. export and serve through torch.export artifacts
    path_launches["export"], export_times = export_phase(
        dt, hp_nn, rng, card, serve_ms, family["ae_fwd_ms"])
    export_times["dispatch"] = dispatch_cost(dt, hp_nn, card)
    # 14. the reference's kNN graph, a TF2 checkpoint's weights, remat,
    # the profiler's layer scopes and the filters
    knn_paths, knn_times = knn_phase(dev, card, rng)
    path_launches.update(knn_paths)
    # 15. the bfloat16 modes: kernels, the headline conv, quick_start
    path_launches.update(bf16_phase(dev, card, rng, qs_st, st1024, results,
                                    serve_ms))

    # main-path kernel times: the quick_start convs' three shapes summed
    path_launches["quick_start_train"] = train_launches
    path_launches["sharded_train"] = shard_launches

    def entry(kname, route, source, replaces):
        rows = results[kname]
        # a kernel the quick_start shapes do not launch: its own rows
        qs = [r for r in rows if r[0].startswith("quick_start")] or rows
        # the side of the bound that holds most of the summed bound
        share = {b: sum(r[4] for r in qs if r[5] == b)
                 for b in ("bytes", "operations")}
        return {
            "name": kname, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(p.get(kname, 0) for p in path_launches.values()),
            "paths": {nm: p.get(kname, 0) for nm, p in path_launches.items()},
            "max_abs_err": max(r[1] for r in rows),
            "ms": sum(r[2] for r in qs), "plain_ms": sum(r[3] for r in qs),
            "bound_ms": sum(r[4] for r in qs),
            "bound_by": max(share, key=share.get),
            "library_ms": (None if qs[0][6] is None
                           else sum(r[6] for r in qs)),
        }

    # launches: each kernel's counts on the main paths, each counted from 0
    # (quick_start training for K1-K4, the sharded training for K5, the lap
    # chain, the chain-routed cface conv, the autoencoder, the residual
    # stack, the smoothing at bench.py's configuration and masked, and the
    # kitchen sink), their sum under "launches"
    kernels = [
        entry("strips", "cuda", "deepsphere_tpu_torch/csrc/strips.cu",
              "deepsphere_tpu/ops/pallas_strips.py:183"),
        entry("stencil_conv", "cuda",
              "deepsphere_tpu_torch/csrc/stencil_conv.cu",
              "deepsphere_tpu/ops/pallas_stencil.py:522"),
        entry("dxdw", "cuda", "deepsphere_tpu_torch/csrc/stencil_dxdw.cu",
              "deepsphere_tpu/ops/pallas_stencil.py:688"),
        entry("grad", "cuda", "deepsphere_tpu_torch/csrc/stencil_grad.cu",
              "deepsphere_tpu/ops/pallas_stencil.py:614"),
        entry("bands", "cuda", "deepsphere_tpu_torch/csrc/bands.cu",
              "deepsphere_tpu/ops/stencil.py:82"),
    ]
    # the bfloat16 instantiations (phase 15): band mode and I/O mode, each
    # staged in float32 or (_s2) in 2-byte shared elements, and K4 on the
    # I/O mode's 2-byte strips
    for kname, line in (("stencil_conv", "pallas_stencil.py:522"),
                        ("dxdw", "pallas_stencil.py:688"),
                        ("grad", "pallas_stencil.py:614")):
        for sfx in ("_bf16", "_bf16_io", "_bf16_s2", "_bf16_io_s2"):
            src = ("" if kname == "stencil_conv" else "stencil_") + kname \
                + sfx.replace("_io_s2", "_s2")
            kernels.append(entry(kname + sfx, "cuda",
                                 f"deepsphere_tpu_torch/csrc/{src}.cu",
                                 f"deepsphere_tpu/ops/{line}"))
    kernels.append(entry("strips_bf16", "cuda",
                         "deepsphere_tpu_torch/csrc/strips.cu",
                         "deepsphere_tpu/ops/pallas_strips.py:183"))
    say("paths", f"launches by path: {path_launches}; lap chain times "
        f"{chain_times}; family {family}; smoothing and kitchen sink "
        f"{slice_times}; export {export_times}; knn {knn_times}")
    for kname, rows in results.items():
        for r in rows:
            if r[0].startswith("headline"):
                say("headline", f"{kname}: {r[2]:.4f} ms, plain {r[3]:.4f} ms, "
                    f"bound {r[4]:.4f} ms ({r[5]}), library "
                    f"{'none' if r[6] is None else f'{r[6]:.4f} ms'}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
        if sys.argv[1] == "--kernel-times":
            kernel_times(sys.argv[2], "--s2" in sys.argv[3:])
        elif sys.argv[1] == "--compare":
            rest = [a for a in sys.argv[3:] if a != "--s2"]
            compare(sys.argv[2], rest[0] if rest else None,
                    "--s2" in sys.argv[3:])
        elif sys.argv[1] == "--replay":
            replay(*sys.argv[2:])
        elif sys.argv[1] == "--memory":
            memory_report(*sys.argv[2:3])
        elif sys.argv[1] == "--sass":
            sass_check(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else None)
        elif sys.argv[1] == "--ab" and len(sys.argv) > 2:
            rest, parent = sys.argv[3:], None
            if "--parent" in rest:
                i = rest.index("--parent")
                parent = rest[i + 1]
                rest = rest[:i] + rest[i + 2:]
            ab(sys.argv[2], [a for a in rest if a != "--s2"], parent,
               "--s2" in rest)
        else:
            raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    else:
        main()
