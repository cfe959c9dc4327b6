#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

Run from the root of a checkout on a machine with an H100 (sm_90):

    python3 chip_smoke.py

Phases, one result line each (with the elapsed seconds):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` compiles ``deepsphere_tpu_torch/csrc/*.cu`` (ptxas
   register / spill lines are printed);
3. kernels against their plain PyTorch versions on identical CUDA inputs,
   at the strip and conv shapes of the quick_start convs 1-3 (batch 16) and
   of the headline conv: the strip gather must match exactly, the raw
   fused conv and the corrected conv to max|d| <= 2e-5 * max|y_plain| (both
   float32 without TF32; only the order of the sums differs);
4. serving: the quick_start classifier at nside 64, full width, random
   weights from a seed, answers 4 requests of 16 maps through
   ``model.predict`` on the card; each of the three cface convs must launch
   both kernels once per forward, and the logits must match the same model
   on the CPU (plain path) to max rel 1e-4;
5. the headline conv (nside 1024, K=5 Chebyshev, Fin=Fout=4, batch 4) on the
   kernels against the plain per-step path, both on the card.

It then prints the card line, one JSON line with every kernel's launches,
error and times, and finally ``{"ok": true, "device": {...}}``.  Any
failure raises: the script exits non-zero and prints no result line.  It
needs one card, never falls back to the CPU, and imports no JAX.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 2e-5  # max|kernel - plain| / max|plain|, float32 sums in another order
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


def rel_err(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / max(scale, 1e-30)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deepsphere_tpu_torch as dt
    from deepsphere_tpu_torch.graph import build_sphere_graph
    from deepsphere_tpu_torch.nn import healpy_layers as hp_nn
    from deepsphere_tpu_torch.ops import _cuda
    from deepsphere_tpu_torch.ops import fused_stencil as fs
    from deepsphere_tpu_torch.ops.stencil import (
        as_tensors,
        cface_embed,
        stencil_graph_conv,
        stencil_tables,
    )
    from deepsphere_tpu_torch.ops.strips import build_strips, strip_arrays

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say("card", f"{card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | capability {torch.cuda.get_device_capability(0)}")

    # 2. build
    path, secs, log = _cuda.build()
    _cuda.lib()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say("build", f"{secs:.2f} s -> {os.path.basename(path)}")
    for ln in ptxas:
        print("    " + ln)

    rng = np.random.RandomState(1234)
    results = {"strips": [], "stencil_conv": []}

    def conv_case(label, st, B, Fin, Fout, K):
        """Phase-3 checks and times at one conv shape."""
        n, h = st.nside, st.n_steps
        _, P_l = fs.cfp_geometry(n, h)
        tables = as_tensors(stencil_tables(st), dev)
        # garbage in the halo lanes too: neither path may read them
        xc = torch.from_numpy(
            rng.normal(size=(B * Fin, 12, n, P_l)).astype(np.float32)).to(dev)
        kernel = torch.from_numpy(
            (rng.normal(size=(Fin * K, Fout)) / np.sqrt(Fin * K)).astype(np.float32)
        ).to(dev)
        wk3 = kernel.reshape(Fin, K, Fout).permute(1, 0, 2).contiguous()
        idx = tables["strip_idx"]

        got = build_strips(st, xc, idx)
        want = strip_arrays(st, xc)
        for nm, g, w in zip(("top", "bot", "ls"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: strip {nm} differs from the "
                                     "plain version")
        ms_k4 = cuda_ms(lambda: build_strips(st, xc, idx))
        ms_k4p = cuda_ms(lambda: strip_arrays(st, xc), iters=3, warmup=1)

        args = (st, "cheby", K, xc, tables["weights"], want, wk3, B)
        y_k = fs.run_stencil_kernel(*args, offsets=tables["offsets"])
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
        yc_k = fs.fused_stencil_conv_cfp(*conv)
        yc_p = fs.fused_stencil_conv_cfp_plain(*conv)
        corr = rel_err(yc_k[..., inner], yc_p[..., inner])
        if not corr <= TOL:
            raise AssertionError(f"{label}: corrected conv rel err {corr:.3e}")
        ms_k1 = cuda_ms(lambda: fs.run_stencil_kernel(
            *args, offsets=tables["offsets"]))
        ms_k1p = cuda_ms(lambda: fs.run_stencil_plain(*args), iters=3,
                         warmup=1)
        abs_k1 = (y_k[..., inner] - y_p[..., inner]).abs().max().item()
        say("kernels", f"{label}: strips exact {ms_k4:.4f} ms (plain "
            f"{ms_k4p:.4f}) | raw conv rel {raw:.2e} abs {abs_k1:.2e} "
            f"{ms_k1:.4f} ms (plain {ms_k1p:.4f}) | corrected rel {corr:.2e}")
        results["strips"].append((label, 0.0, ms_k4, ms_k4p))
        results["stencil_conv"].append((label, abs_k1, ms_k1, ms_k1p))

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

    t = time.perf_counter()
    g1024 = build_sphere_graph(1024, k=8, method="grid")
    st1024 = g1024.deep_stencil(0.75, 5)
    head_graph_s = time.perf_counter() - t
    say("kernels", f"headline graph + stencil built in {head_graph_s:.2f} s")
    conv_case("headline nside=1024 B=4 Fin=4 Fout=4 K=5", st1024, 4, 4, 4, 5)

    # 4. serving: the quick_start classifier at nside 64
    nside = 64
    npix = 12 * nside * nside
    layers = [
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
    t = time.perf_counter()
    model = dt.HealpyGCNN(nside=nside, indices=np.arange(npix), layers=layers)
    model.build((16, npix, 1), seed=7)
    bn_rng = np.random.RandomState(8)
    cface_convs = []
    for key, layer in model.layers.items():
        if getattr(layer, "bn", None) is not None:
            F = layer.bn.mean.shape[0]
            layer.bn.mean.copy_(torch.from_numpy(
                bn_rng.normal(scale=0.1, size=F).astype(np.float32)))
            layer.bn.var.copy_(torch.from_numpy(
                bn_rng.uniform(0.5, 2.0, size=F).astype(np.float32)))
        if getattr(layer, "layout", None) == "cface" and hasattr(layer, "graph"):
            cface_convs.append((key, layer._stencil()))
    plan = [type(m).__name__ for m in model.layers.values()]
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    say("serving", f"model built in {time.perf_counter() - t:.2f} s; plan "
        f"{plan}")
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
    for k in ("strips", "stencil_conv"):
        if launches[k] != 3 * n_fwd:
            raise AssertionError(f"{k} launched {launches[k]} times in "
                                 f"{n_fwd} forwards, expected {3 * n_fwd}")
    if logits.shape != (64, 4) or not np.all(np.isfinite(logits)):
        raise AssertionError(f"bad logits: shape {logits.shape}")
    t = time.perf_counter()
    ref = cpu_model.predict(x, batch_size=16)
    cpu_s = time.perf_counter() - t
    rel = float(np.abs(logits - ref).max() / np.abs(ref).max())
    if not rel <= 1e-4:
        raise AssertionError(f"card logits differ from the CPU by rel {rel:.3e}")
    xb = torch.from_numpy(x[:16]).to(dev)
    model.eval()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(xb), iters=20, warmup=3)
    say("serving", f"4 requests x 16 maps: logits {logits.shape}, finite, "
        f"launches {launches}; max rel vs CPU {rel:.2e} (CPU took "
        f"{cpu_s:.1f} s); {fwd_ms:.3f} ms per forward of 16 maps "
        f"({16e3 / fwd_ms:.1f} maps/s) on {card}")

    # 5. headline conv: kernels vs the plain per-step path, both on the card
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

    # main-path kernel times: the quick_start forward's three shapes summed
    def entry(kname, route, source, replaces):
        rows = results[kname]
        qs = [r for r in rows if r[0].startswith("quick_start")]
        return {
            "name": kname, "route": route, "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r[1] for r in rows),
            "ms": sum(r[2] for r in qs), "plain_ms": sum(r[3] for r in qs),
        }

    kernels = [
        entry("strips", "cuda", "deepsphere_tpu_torch/csrc/strips.cu",
              "deepsphere_tpu/ops/pallas_strips.py:183"),
        entry("stencil_conv", "cuda",
              "deepsphere_tpu_torch/csrc/stencil_conv.cu",
              "deepsphere_tpu/ops/pallas_stencil.py:522"),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
