#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the repository root; it puts ``src`` on ``sys.path`` itself and
imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line per case, in order; any failure ends the run with a non-zero
exit code:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``, with
   ptxas' register and shared-memory report; fails on a spill in a
   tensor-core kernel (``ce_tc_*``, ``flash_tc_*``) and when a kernel
   that moves registers with setmaxnreg (``ce_tc_*``, ``flash_tc_fwd``,
   ``flash_tc_dkdv``) does not enter with 168 of them;
3. rms_norm: kernel vs its plain PyTorch version at gemma-2b's training
   (2048 rows), prefill (8*1024) and decode (8) shapes, d = 2048, fp32
   and bf16, and at mamba2-2.7b's (d 2560 and 5120, bf16); the backward
   kernel at the training shapes;
4. flash_attention: kernel vs its plain version at gemma-2b's training
   (B 8, H 8, KV 1, S 256, D 256) and prefill (S 1024) shapes and on
   small GQA cases with a window, a softcap, a ragged S and Sq != Sk;
   the bf16 output also against the plain version in fp32 arithmetic,
   and the forward's LSE against that version's; the backward kernels
   on the forward kernel's output and LSE at the training shape and on
   the small cases, against the plain formulas on the plain forward's
   output and LSE, the bf16 tensor-core backward also against its
   bf16-P/dS formulas and bitwise against a second run; the device time
   of each bf16 tensor-core kernel (``flash_tc_fwd``;
   ``flash_bwd_delta``, ``flash_tc_dkdv``, ``flash_tc_combine``,
   ``flash_tc_dq``) from the profiler;
5. ce_loss: the fused cross-entropy forward and backward at gemma-2b's
   training shape (T 2040, V 256000, d 2048, bf16), at mamba2-2.7b's
   (T 2040, V 50280, d 2560, bf16) and in fp32 at T 77, V 1000, d 64;
   the bf16 backward also against its chunked bf16-P formulas; a second
   run of each must be bitwise equal; the device time of each bf16
   kernel (forward and combine; ``ce_tc_p`` / ``ce_tc_dw`` / ``ce_tc_dx``)
   from the profiler.  The build phase fails on a spill in a bf16
   ``ce_loss`` kernel;
6. ssd_scan: the Mamba-2 SSD scan kernel vs both plain versions (chunked
   and naive), y and the final state, at mamba2-2.7b's training (B 8,
   S 256, H 80, P 64, N 128, chunk 256; fp32 and bf16) and prefill
   (S 1024, bf16) shapes, a ragged S (1000), the JAX tests' small shapes
   and a case whose decay overflows fp32 above the diagonal; the backward
   kernel vs the plain backward formulas and, in fp32 at S <= 256,
   autograd of the naive recurrence;
then, for gemma-2b and then mamba2-2.7b:
7. model parity: full width and depth 2, fp32, the model on the card
   (kernels) against a copy on the CPU (plain versions), prefill of 128
   tokens and 8 teacher-forced decode steps;
8. serving: full width and depth in bf16 through ``ServeEngine.generate``
   (8 requests, 1024 prompt tokens, 32 new), with the kernel launch
   counts of that run, and a profile of a prefill (gemma-2b: every flash
   launch in it a ``flash_tc_fwd``, by the profiler's kernel names);
9. train parity: full width and depth 2, fp32, batch 2 x 64: loss, every
   gradient and the params after one AdamW step, the card against a CPU
   copy;
10. training (the main paths): full width and depth, bf16 params with
    fp32 AdamW state, through ``ElasticTrainer`` at the JAX trainer's
    defaults (per-node batch 8, seq 256): rescale(1), 6 steps, park,
    unpark, 2 steps, with the launches of every step, then one profiled
    step (gemma-2b: every flash launch in it, forward and backward, a
    tensor-core kernel, by the profiler's kernel names);
11. elastic (gemma-2b): that trainer under ``BFTrainerRuntime`` with the
    fast MILP allocator over a replayed idle-node trace;
12. a ``kernels`` line: each kernel's launches in one training step of
    the newest main path that runs it (mamba2-2.7b, and gemma-2b for
    flash attention), its launches on every path, and its error, times
    and bound at that path's training shape, in bf16.

Tolerances: kernels 2e-5 (fp32) / 2e-2 (bf16), those of the JAX
package's kernel tests; a bf16 output is held to 2e-2 of
max(|plain|, 1) elementwise, one bf16 ulp with margin.  The bf16 flash
forward also to 5e-3 of max(|plain|, 1) against the plain version in
fp32 arithmetic, and its LSE to 1e-5 (fp32) / 1e-4 (bf16).  The SSD scan
1e-4 (fp32) / 0.08 (bf16), those of its JAX test.  Gradients: 1e-4
(fp32) / 2e-2 (bf16) of the largest |gradient|.  Model and train parity
1e-3 of the largest value of each output or leaf: fp32 with TF32 off
(set below for matmuls and cuDNN), so the card and the CPU differ only
in the order sums are taken.  Times are CUDA-event means over repeated
launches after a warm-up; the inputs are not flushed from L2 between
launches, as the model's caller finds them freshly written.  Bounds use
the H100 SXM data-sheet peaks: 3.35 TB/s of HBM, 989 TFLOP/s in bf16 on
the tensor cores and 67 TFLOP/s in fp32 without them.  No single PyTorch
call computes the SSD scan, so its ``library_ms`` is null.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODEL_TOL = 1e-3
# bf16 flash forward against the plain version in fp32 arithmetic on the
# same inputs, relative to max(|want|, 1): the kernel's own error, half a
# bf16 ulp of the output (<= 1.95e-3 below 1) plus P's rounding to bf16;
# 2.7e-3 at most was measured on an H100.  The bf16 plain version rounds
# its scores, P and output, so against it one ulp (3.9e-3 at [0.5, 1))
# is the rule and only TOL holds.
FLASH_FWD_TOL_FP32_MATH = 5e-3
# the forward's fp32 LSE against the plain version's in fp32 arithmetic
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
ELEMENTWISE_FLOPS = 67e12   # fp32 outside the tensor cores


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / max(|want|, 1), elementwise."""
    diff = (got.float() - want.float()).abs()
    return float((diff / want.float().abs().clamp(min=1.0)).max())


def out_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The error a forward output is held to: absolute in fp32; in bf16
    relative to max(|want|, 1) elementwise (one bf16 ulp is 2**-8 of the
    value, so an absolute bound fails on outputs of 4 or more)."""
    if want.dtype == torch.bfloat16:
        return scaled_err(got, want)
    return max_err(got, want)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error relative to the largest |want| (gradients)."""
    return max_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def dt_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    return line


# The tensor-core kernels (ce_tc_*, flash_tc_*) hold 64 x 256 fp32
# accumulators in registers: a spill there is a design fault, not a
# tuning matter.  Those of 384 threads move registers between their
# warpgroups with setmaxnreg (the consumers up, the producer down), which
# balances only if the kernel enters with 65,536 / 384 rounded down to 8,
# that is 168: with fewer, the consumers' setmaxnreg.inc waits forever.
TC_FAMILIES = ("ce_tc_", "flash_tc_")
SETMAXNREG_KERNELS = ("ce_tc_", "flash_tc_fwd", "flash_tc_dkdv")
SETMAXNREG_ENTRY = 168


def ptxas_report(log: str) -> dict[str, str]:
    """ptxas' register, spill and shared-memory lines, by kernel."""
    ptxas, fn = {}, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill stores" in ln or "Used" in ln:
            ptxas[fn] = (ptxas.get(fn, "") + " " + ln.strip()).strip()
    return ptxas


def tc_faults(ptxas: dict[str, str]) -> dict:
    """The tensor-core kernels' count by family, their spills, and the
    setmaxnreg kernels whose register count at entry is not 168."""
    spills = {f: r for f, r in ptxas.items()
              if any(t in f for t in TC_FAMILIES)
              and not ("0 bytes spill stores" in r and "0 bytes spill loads" in r)}
    entry = {}
    for f, r in ptxas.items():
        if any(t in f for t in SETMAXNREG_KERNELS):
            m = re.search(r"Used (\d+) registers", r)
            entry[f] = int(m.group(1)) if m else None
    return {"tc_kernels": {t: sum(t in f for f in ptxas) for t in TC_FAMILIES},
            "tc_spills": spills,
            "setmaxnreg_kernels": len(entry),
            "setmaxnreg_bad_entry": {f: n for f, n in entry.items()
                                     if n != SETMAXNREG_ENTRY}}


def phase_build(build) -> None:
    t0 = time.perf_counter()
    build.build(force=True)
    build.library()
    seconds = time.perf_counter() - t0
    ptxas = ptxas_report(build.BUILD_LOG)
    faults = tc_faults(ptxas)
    emit({"phase": "build", "seconds": seconds,
          "source_seconds": build.BUILD_SECONDS, "ptxas": ptxas, **faults})
    if faults["tc_spills"] or not all(faults["tc_kernels"].values()):
        fail(f"tensor-core kernels spill or are missing: {faults}")
    if faults["setmaxnreg_bad_entry"] or not faults["setmaxnreg_kernels"]:
        fail("setmaxnreg kernels must enter with "
             f"{SETMAXNREG_ENTRY} registers: {faults}")


RMS_CASES = [
    # (rows, d, dtypes): gemma-2b's training (2048), prefill (8 x 1024) and
    # decode (8) rows at d 2048; mamba2-2.7b's at d 2560 (the block norm)
    # and 5120 (the gated norm), bf16
    *((rows, 2048, (torch.float32, torch.bfloat16))
      for rows in (2048, 8 * 1024, 8)),
    *((rows, d, (torch.bfloat16,)) for d in (2560, 5120)
      for rows in (2048, 8 * 1024, 8)),
]


def phase_rms_norm(ops, ref) -> dict:
    """Forward at the training, prefill and decode shapes; backward at the
    training shapes.  Returns the bf16 cases at the training shape of
    gemma-2b (d 2048) and of mamba2-2.7b's gated norm (d 5120)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    main = {}
    for rows, d, dtypes in RMS_CASES:
        for dtype in dtypes:
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            s = torch.randn(d, generator=gen, device="cuda") * 0.1
            err = out_err(ops.rms_norm(x, s), ref.rms_norm_ref(x, s))
            w = (1.0 + s).to(dtype)
            case = {
                "phase": "rms_norm", "rows": rows, "d": d,
                "dtype": dt_name(dtype),
                "max_abs_err": max_err(ops.rms_norm(x, s),
                                       ref.rms_norm_ref(x, s)),
                "err": err, "tol": TOL[dtype],
                "ms": time_ms(lambda: ops.rms_norm(x, s)),
                "plain_ms": time_ms(lambda: ref.rms_norm_ref(x, s)),
                "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
            }
            case["bound_ms"], case["bound_by"] = bound(
                2 * x.numel() * x.element_size() + 4 * d, 4 * x.numel(),
                ELEMENTWISE_FLOPS)
            emit(case)
            if not err <= TOL[dtype]:
                fail(f"rms_norm {rows}x{d} {dtype}: err {err}")
            if rows == 2048:
                bwd = _rms_norm_bwd_case(ops, ref, x, s, gen)
                if dtype == torch.bfloat16 and d in (2048, 5120):
                    main[d] = {"rms_norm": case, "rms_norm_bwd": bwd}
    return main


def _grad_time(out: torch.Tensor, inputs, grad_out, iters: int = 20,
               warmup: int = 3) -> float:
    """CUDA-event time of autograd's backward through a recorded graph."""
    return time_ms(lambda: torch.autograd.grad(out, inputs, grad_out,
                                               retain_graph=True),
                   iters, warmup)


def _rms_norm_bwd_case(ops, ref, x, s, gen) -> dict:
    dtype, (rows, d) = x.dtype, x.shape
    dy = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    dx, ds = ops._rms_norm_bwd(x, s, dy, 1e-6)
    want_dx, want_ds = ref.rms_norm_bwd_ref(x, s, dy)
    err = max(rel_err(dx, want_dx), rel_err(ds, want_ds))
    case = {"phase": "rms_norm_bwd", "rows": rows, "d": d,
            "dtype": dt_name(dtype),
            "max_abs_err": max(max_err(dx, want_dx), max_err(ds, want_ds)),
            "rel_err": err, "tol": GRAD_TOL[dtype]}
    if dtype == torch.float32:        # and autograd of the plain forward
        xa, sa = x.clone().requires_grad_(), s.clone().requires_grad_()
        ga = torch.autograd.grad(ref.rms_norm_ref(xa, sa), (xa, sa), dy)
        case["rel_err_autograd"] = max(rel_err(dx, ga[0]), rel_err(ds, ga[1]))
        err = max(err, case["rel_err_autograd"])
    case["ms"] = time_ms(lambda: ops._rms_norm_bwd(x, s, dy, 1e-6))
    case["plain_ms"] = time_ms(lambda: ref.rms_norm_bwd_ref(x, s, dy))
    xl = x.clone().requires_grad_()
    wl = (1.0 + s).to(dtype).requires_grad_()
    case["library_ms"] = _grad_time(F.rms_norm(xl, (d,), wl, 1e-6),
                                    (xl, wl), dy)
    case["bound_ms"], case["bound_by"] = bound(
        3 * x.numel() * x.element_size() + 8 * d, 10 * x.numel(),
        ELEMENTWISE_FLOPS)
    emit(case)
    if not err <= GRAD_TOL[dtype]:
        fail(f"rms_norm backward {rows}x{d} {dtype}: rel err {err}")
    return case


def _pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    q = torch.arange(sq, device="cuda")[:, None]
    k = torch.arange(sk, device="cuda")[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        ok &= k <= q
    if window:
        ok &= k > q - window
    return int(ok.sum())


FLASH_CASES = [
    # (B, H, KV, Sq, Sk, D, causal, window, logit_cap)
    (8, 8, 1, 256, 256, 256, True, 0, 0.0),       # gemma-2b training
    (8, 8, 1, 1024, 1024, 256, True, 0, 0.0),     # gemma-2b prefill
    (2, 4, 2, 256, 256, 128, True, 64, 0.0),      # GQA + window
    (2, 4, 2, 256, 256, 64, True, 0, 50.0),       # GQA + softcap
    (2, 4, 2, 160, 160, 32, True, 0, 0.0),        # ragged S
    (1, 2, 1, 130, 190, 32, False, 0, 0.0),       # Sq != Sk, not causal
]


def phase_flash(ops, ref) -> dict:
    """Forward on every case; backward on every case but the prefill
    shape.  Returns the bf16 cases at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    main = {}
    for b, h, kv, sq, sk, d, causal, window, cap in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape):
                return (torch.randn(*shape, generator=gen, device="cuda")
                        * 0.3).to(dtype)
            q, k, v = rnd(b, h, sq, d), rnd(b, kv, sk, d), rnd(b, kv, sk, d)
            kw = dict(causal=causal, window=window, logit_cap=cap)
            want = ref.flash_attention_ref(q, k, v, **kw)
            # the plain version in fp32 arithmetic on the same inputs: an
            # unrounded output, and the LSE the backward is built from
            plain_o, plain_lse = ref.flash_attention_ref(
                q.float(), k.float(), v.float(), return_lse=True, **kw)
            got = ops.flash_attention(q, k, v, **kw)
            _, lse = ops._flash_fwd(q, k, v, causal, window, cap, d ** -0.5,
                                    True)
            err = out_err(got, want)
            case = {
                "phase": "flash_attention", "shape": [b, h, kv, sq, sk, d],
                "dtype": dt_name(dtype), **kw,
                "max_abs_err": max_err(got, want), "err": err,
                "tol": TOL[dtype],
                "lse_err": max_err(lse, plain_lse), "lse_tol": LSE_TOL[dtype],
            }
            ok = err <= TOL[dtype] and case["lse_err"] <= LSE_TOL[dtype]
            if dtype == torch.bfloat16:
                case["err_fp32_math"] = scaled_err(got, plain_o)
                case["tol_fp32_math"] = FLASH_FWD_TOL_FP32_MATH
                ok = ok and case["err_fp32_math"] <= FLASH_FWD_TOL_FP32_MATH
            del want
            plain_o = plain_o.to(dtype)
            case["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
            case["plain_ms"] = time_ms(
                lambda: ref.flash_attention_ref(q, k, v, **kw))
            case["library_ms"] = None
            sdpa = causal and not window and not cap and sq == sk
            if sdpa:
                ke = k.repeat_interleave(h // kv, dim=1)
                ve = v.repeat_interleave(h // kv, dim=1)

                def lib():
                    return F.scaled_dot_product_attention(q, ke, ve,
                                                          is_causal=True)
                case["library_ms"] = time_ms(lib)
                case["library_device_ms"] = _device_ms(lib)
            pairs = _pairs(sq, sk, causal, window)
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            flops = 4 * d * b * h * pairs
            case["bound_ms"], case["bound_by"] = bound(
                nbytes, flops, PEAK_FLOPS[dtype])
            case["route"] = ops.flash_route(dtype, d)
            case["peak_share"] = flops / (case["ms"] * 1e-3) / PEAK_FLOPS[dtype]
            if case["route"] == "tensor_core":
                _device_times(case, lambda: ops.flash_attention(q, k, v, **kw),
                              ("flash_tc_fwd",), flops)
            emit(case)
            if not ok:
                fail(f"flash_attention {case['shape']} {kw} {dtype}: err "
                     f"{err}, lse err {case['lse_err']}, err against fp32 "
                     f"arithmetic {case.get('err_fp32_math')}")
            if sq == 1024:
                continue
            bwd = _flash_bwd_case(ops, ref, q, k, v, got, lse,
                                  (plain_o, plain_lse), kw, pairs, gen, sdpa)
            if sq == 256 and d == 256 and dtype == torch.bfloat16:
                main["flash_attention"], main["flash_attention_bwd"] = case, bwd
    return main


def _flash_bwd_case(ops, ref, q, k, v, o, lse, plain, kw, pairs, gen,
                    sdpa) -> dict:
    """The backward kernels on the forward kernel's (o, lse), held against
    the plain formulas on the plain forward's ``plain`` (o, lse): a wrong
    LSE from the forward kernel moves only the kernels' side."""
    b, h, sq, d = q.shape
    kv, dtype = k.shape[1], q.dtype
    scale = d ** -0.5
    args = (kw["causal"], kw["window"], kw["logit_cap"], scale)
    do = (torch.randn(q.shape, generator=gen, device="cuda") * 0.3).to(dtype)
    got = ops._flash_bwd(q, k, v, o, lse, do, *args)
    want = ref.flash_attention_bwd_ref(q, k, v, *plain, do, **kw)
    err = max(rel_err(g, w) for g, w in zip(got, want))
    route = ops.flash_route(dtype, d)
    case = {"phase": "flash_attention_bwd",
            "shape": [b, h, kv, sq, k.shape[2], d], "dtype": dt_name(dtype),
            **kw, "route": route,
            "max_abs_err": max(max_err(g, w) for g, w in zip(got, want)),
            "rel_err": err, "tol": GRAD_TOL[dtype], "library_ms": None}
    if route == "tensor_core":        # P and dS rounded to bf16, no atomics
        want = ref.flash_attention_bwd_rounded_ref(q, k, v, *plain, do, **kw)
        case["rel_err_rounded"] = max(rel_err(g, w)
                                      for g, w in zip(got, want))
        err = max(err, case["rel_err_rounded"])
        again = ops._flash_bwd(q, k, v, o, lse, do, *args)
        case["bitwise_repeat"] = all(torch.equal(g, a)
                                     for g, a in zip(got, again))
        case["splits"] = ops.flash_dkdv_splits(
            b, kv, k.shape[2], h // kv,
            torch.cuda.get_device_properties(0).multi_processor_count)
        del again
    del want
    if dtype == torch.float32:        # and autograd of the plain forward
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ga = torch.autograd.grad(ref.flash_attention_ref(*leaves, **kw),
                                 leaves, do)
        case["rel_err_autograd"] = max(rel_err(g, w) for g, w in zip(got, ga))
        err = max(err, case["rel_err_autograd"])
    case["ms"] = time_ms(lambda: ops._flash_bwd(q, k, v, o, lse, do, *args))
    case["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, **kw))
    if sdpa:
        ql = q.clone().requires_grad_()
        kl = k.repeat_interleave(h // kv, dim=1).requires_grad_()
        vl = v.repeat_interleave(h // kv, dim=1).requires_grad_()
        lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        case["library_ms"] = _grad_time(lib, (ql, kl, vl), do)
        case["library_device_ms"] = _device_ms(
            lambda: torch.autograd.grad(lib, (ql, kl, vl), do,
                                        retain_graph=True))
        del lib
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * b * h * sq
    flops = 10 * d * b * h * pairs
    case["bound_ms"], case["bound_by"] = bound(nbytes, flops,
                                               PEAK_FLOPS[dtype])
    case["peak_share"] = flops / (case["ms"] * 1e-3) / PEAK_FLOPS[dtype]
    if route == "tensor_core":
        _device_times(case, lambda: ops._flash_bwd(q, k, v, o, lse, do, *args),
                      ("flash_bwd_delta", "flash_tc_dkdv", "flash_tc_combine",
                       "flash_tc_dq"), flops)
    emit(case)
    if not err <= GRAD_TOL[dtype]:
        fail(f"flash_attention backward {case['shape']} {kw} {dtype}: "
             f"rel err {err}")
    if not case.get("bitwise_repeat", True):
        fail(f"flash_attention backward {case['shape']} {kw}: two runs "
             "differ")
    return case


def _device_ms(fn) -> float:
    """Device ms of every kernel one call of ``fn`` launches (profiler):
    without the host's share, which CUDA events over back-to-back calls
    include when the host is slower than the device."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def _device_times(case: dict, fn, names, flops: float) -> None:
    """A tensor-core flash case's device ms by kernel and in all, and the
    share of the bf16 peak that the device time gives."""
    case["kernel_ms"] = _kernel_ms(fn, names)
    case["device_ms"] = _device_ms(fn)
    case["device_peak_share"] = (flops / (case["device_ms"] * 1e-3)
                                 / PEAK_FLOPS[torch.bfloat16])


def _kernel_ms(fn, names) -> dict:
    """Device ms of one call of ``fn``, by kernel, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for n in names:
            if n + "(" in e.key or n + "<" in e.key:
                ms[n] += e.self_device_time_total / 1e3
    return {n: t if t else "not measured" for n, t in ms.items()}


CE_CASES = [
    # (T, V, d, dtype)
    (2040, 256000, 2048, torch.bfloat16),   # gemma-2b training: 8 x 255
    (2040, 50280, 2560, torch.bfloat16),    # mamba2-2.7b training
    (77, 1000, 64, torch.float32),
]


def phase_ce_loss(ops, ref) -> dict:
    """Forward and backward; returns the training-shape cases, keyed by
    the vocabulary size."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    main = {}
    for t, v, d, dtype in CE_CASES:
        x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(v, d, generator=gen, device="cuda") * 0.02).to(dtype)
        labels = torch.randint(0, v, (t,), generator=gen, device="cuda")
        lbl32 = labels.to(torch.int32)
        g = torch.full((t,), 1.0 / t, device="cuda")      # d(mean)/d(loss)
        iters = 3 if v > 10_000 else 20
        loss, logz = ops._ce_fwd(x, w, lbl32)
        want = ref.ce_loss_ref(x, w, labels)
        err = max(max_err(loss, want),
                  max_err(logz, ref.ce_loss_logz_ref(x, w)))
        esz, peak = x.element_size(), PEAK_FLOPS[dtype]
        fwd = {"phase": "ce_loss", "T": t, "V": v, "d": d,
               "dtype": dt_name(dtype), "max_abs_err": err,
               "tol": TOL[dtype],
               "ms": time_ms(lambda: ops._ce_fwd(x, w, lbl32), iters, 1),
               "plain_ms": time_ms(lambda: ref.ce_loss_ref(x, w, labels),
                                   iters, 1),
               "library_ms": time_ms(lambda: F.cross_entropy(
                   (x @ w.T).float(), labels, reduction="none"), iters, 1)}
        fwd["bound_ms"], fwd["bound_by"] = bound(
            (t * d + v * d) * esz + 12 * t, 2 * t * v * d, peak)
        if not err <= TOL[dtype]:
            emit(fwd)
            fail(f"ce_loss {t}x{v}x{d} {dtype}: err {err}")

        dx, dw = ops._ce_bwd(x, w, lbl32, logz, g)
        want_dx, want_dw = ref.ce_loss_bwd_ref(x, w, labels, logz, g)
        err = max(rel_err(dx, want_dx), rel_err(dw, want_dw))
        bwd = {"phase": "ce_loss_bwd", "T": t, "V": v, "d": d,
               "dtype": dt_name(dtype),
               "max_abs_want": max(float(want_dx.float().abs().max()),
                                   float(want_dw.float().abs().max())),
               "n_differ": int((dx != want_dx).sum() + (dw != want_dw).sum()),
               "max_abs_err": max(max_err(dx, want_dx), max_err(dw, want_dw)),
               "rel_err": err, "tol": GRAD_TOL[dtype]}
        del want_dx, want_dw
        if dtype == torch.bfloat16:   # and the chunked, bf16-P formulas
            cdx, cdw = ref.ce_loss_bwd_chunked_ref(x, w, labels, logz, g,
                                                   ops.ce_chunk(v))
            bwd["rel_err_chunked"] = max(rel_err(dx, cdx), rel_err(dw, cdw))
            err = max(err, bwd["rel_err_chunked"])
            del cdx, cdw
        # no atomics: a second run is bitwise equal
        loss2, logz2 = ops._ce_fwd(x, w, lbl32)
        dx2, dw2 = ops._ce_bwd(x, w, lbl32, logz, g)
        fwd["bitwise_repeat"] = bool(torch.equal(loss, loss2)
                                     and torch.equal(logz, logz2))
        bwd["bitwise_repeat"] = bool(torch.equal(dx, dx2)
                                     and torch.equal(dw, dw2))
        del loss2, logz2, dx2, dw2
        if dtype == torch.bfloat16:   # device time of each kernel
            fwd["kernel_ms"] = _kernel_ms(
                lambda: ops._ce_fwd(x, w, lbl32), ("ce_tc_fwd", "ce_combine"))
            bwd["kernel_ms"] = _kernel_ms(
                lambda: ops._ce_bwd(x, w, lbl32, logz, g),
                ("ce_tc_p", "ce_tc_dw", "ce_tc_dx"))
        emit(fwd)
        if not (fwd["bitwise_repeat"] and bwd["bitwise_repeat"]):
            emit(bwd)
            fail(f"ce_loss {t}x{v}x{d} {dtype}: two runs differ")
        if dtype == torch.float32:    # and autograd of the plain forward
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            ga = torch.autograd.grad(ref.ce_loss_ref(xa, wa, labels),
                                     (xa, wa), g)
            bwd["rel_err_autograd"] = max(rel_err(dx, ga[0]),
                                          rel_err(dw, ga[1]))
            err = max(err, bwd["rel_err_autograd"])
        bwd["ms"] = time_ms(lambda: ops._ce_bwd(x, w, lbl32, logz, g),
                            iters, 1)
        bwd["plain_ms"] = time_ms(lambda: ref.ce_loss_bwd_ref(
            x, w, labels, logz, g), iters, 1)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        lib = F.cross_entropy((xl @ wl.T).float(), labels, reduction="none")
        bwd["library_ms"] = _grad_time(lib, (xl, wl), g, iters, 1)
        del lib, xl, wl
        bwd["bound_ms"], bwd["bound_by"] = bound(
            2 * (t * d + v * d) * esz + 12 * t, 6 * t * v * d, peak)
        emit(bwd)
        if not err <= GRAD_TOL[dtype]:
            fail(f"ce_loss backward {t}x{v}x{d} {dtype}: rel err {err}")
        if v > 10_000:
            main[v] = {"ce_loss": fwd, "ce_loss_bwd": bwd}
        del x, w, dx, dw
        torch.cuda.empty_cache()
    return main


SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.08}
SSD_CASES = [
    # (B, S, H, P, N), chunk, dtypes, backward, label
    ((8, 256, 80, 64, 128), 256, (torch.float32, torch.bfloat16), True,
     "train"),                                  # mamba2-2.7b training
    ((8, 1024, 80, 64, 128), 256, (torch.bfloat16,), False,
     "prefill"),                                # mamba2-2.7b prefill
    ((2, 1000, 16, 64, 128), 256, (torch.float32,), True, "ragged"),
    ((1, 64, 2, 16, 8), 32, (torch.float32,), True, "small"),
    ((2, 128, 3, 32, 16), 64, (torch.float32,), True, "small"),
    ((1, 256, 8, 64, 128), 256, (torch.float32,), True, "overflow"),
]


def _ssd_inputs(shape, dtype, gen, overflow):
    """x, dt, a, B, C on the card.  dt in [0.01, 0.51] and a = -exp(0.3 z),
    the inputs of tests/test_kernels.py; the overflow case takes dt in
    [0.6, 1.1] and a = -1, mamba2-2.7b at its init, where cum falls by
    ~220 across a chunk of 256."""
    b, s, h, p, n = shape

    def rnd(*shp, scale):
        return (torch.randn(*shp, generator=gen, device="cuda") * scale)

    lo, hi = (0.6, 1.1) if overflow else (0.01, 0.51)
    dt = torch.rand(b, s, h, generator=gen, device="cuda") * (hi - lo) + lo
    a = (torch.full((h,), -1.0, device="cuda") if overflow
         else -torch.exp(rnd(h, scale=0.3)))
    return (rnd(b, s, h, p, scale=0.5).to(dtype), dt, a,
            rnd(b, s, h, n, scale=0.4).to(dtype),
            rnd(b, s, h, n, scale=0.4).to(dtype))


def _ssd_work(shape, chunk, esz, bwd, dfinal):
    """(bytes, operations) the scan needs: each input read once and each
    output written once; the products over the causal pairs s <= l of
    every chunk, and the P x N state products only where the state they
    touch is not zero (not before the first chunk; no dstate at the last
    chunk without a final-state cotangent)."""
    b, s, h, p, n = shape
    nc = -(-s // chunk)
    lens = [min(chunk, s - c * chunk) for c in range(nc)]
    pairs = sum(ln * (ln + 1) // 2 for ln in lens)
    lpn = 2 * p * n
    bh = b * h
    rows = b * s * h
    if not bwd:
        ops_ = bh * (pairs * 2 * (n + p) + sum(lens) * lpn
                     + sum(lens[1:]) * lpn)
        nbytes = rows * (2 * p + 2 * n) * esz + rows * 4 + bh * p * n * 4
        return nbytes, ops_
    # G and dW once per pair, then dx, dB and dC
    ops_ = bh * pairs * (6 * n + 4 * p)
    ops_ += bh * 2 * lpn * (sum(lens[:-1]) + (lens[-1] if dfinal else 0))
    ops_ += bh * 2 * lpn * sum(lens[1:])
    nbytes = (rows * (3 * p + 4 * n) * esz + 2 * rows * 4     # x dy dx, B C dB dC
              + (bh * p * n * 4 if dfinal else 0)
              + bh * (nc - 1) * p * n * 4)
    return nbytes, ops_


def phase_ssd_scan(ops, ref) -> dict:
    """The SSD scan kernel against both plain versions (the chunked one
    and the naive recurrence), y and the final state; the backward kernel
    against the plain backward formulas and, in fp32 at S <= 256, autograd
    of the naive recurrence (which cannot overflow).  Returns the bf16
    cases at mamba2-2.7b's training shape."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    main = {}
    for shape, chunk, dtypes, with_bwd, label in SSD_CASES:
        for dtype in dtypes:
            args = _ssd_inputs(shape, dtype, gen, label == "overflow")
            tol = SSD_TOL[dtype]
            y, final = ops.ssd_scan(*args, chunk=chunk)
            errs = {}
            for name, (wy, wf) in (
                    ("chunked", ref.ssd_chunked(*args, chunk=chunk)),
                    ("naive", ref.ssd_scan_ref(*args))):
                errs[name] = max(max_err(y, wy), max_err(final, wf))
            err = max(errs.values())
            finite = bool(torch.isfinite(y).all() and torch.isfinite(final).all())
            esz = args[0].element_size()
            case = {"phase": "ssd_scan", "case": label, "shape": list(shape),
                    "chunk": chunk, "dtype": dt_name(dtype),
                    "max_abs_err": err, "err_vs": errs, "tol": tol,
                    "finite": finite, "library_ms": None}
            iters = 5 if shape[1] > 256 else 20
            case["ms"] = time_ms(lambda: ops.ssd_scan(*args, chunk=chunk),
                                 iters, 1)
            case["plain_ms"] = time_ms(
                lambda: ref.ssd_chunked(*args, chunk=chunk), iters, 1)
            case["bound_ms"], case["bound_by"] = bound(
                *_ssd_work(shape, chunk, esz, False, False), PEAK_FLOPS[dtype])
            emit(case)
            if not (err < tol and finite):
                fail(f"ssd_scan {label} {shape} {dtype}: err {errs}")
            if with_bwd:
                bwd = _ssd_bwd_case(ops, ref, args, chunk, label, gen)
                if label == "train" and dtype == torch.bfloat16:
                    main = {"ssd_scan": case, "ssd_scan_bwd": bwd}
            del args, y, final
            torch.cuda.empty_cache()
    return main


def _ssd_bwd_case(ops, ref, args, chunk, label, gen) -> dict:
    x = args[0]
    dtype, (b, s, h, p) = x.dtype, x.shape
    n = args[3].shape[-1]
    dy = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    # the training path has no final-state cotangent; the others do
    dfinal = (None if label == "train"
              else torch.randn(b, h, p, n, generator=gen, device="cuda"))
    _, _, states = ops._ssd_fwd(*args, chunk, True)
    got = ops._ssd_bwd(*args, dy, dfinal, states, chunk)
    want = ref.ssd_scan_bwd_ref(*args, dy, dfinal, chunk=chunk)
    err = max(rel_err(g, w) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    case = {"phase": "ssd_scan_bwd", "case": label, "shape": [b, s, h, p, n],
            "chunk": chunk, "dtype": dt_name(dtype),
            "final_state_cotangent": dfinal is not None,
            "max_abs_err": max(max_err(g, w) for g, w in zip(got, want)),
            "rel_err": err, "tol": GRAD_TOL[dtype], "finite": finite,
            "library_ms": None}
    del want
    if dtype == torch.float32 and s <= 256:   # autograd of the naive scan
        leaves = [t.clone().requires_grad_() for t in args]
        y, final = ref.ssd_scan_ref(*leaves)
        cot = [dy] + ([dfinal] if dfinal is not None else [])
        ga = torch.autograd.grad([y, final][:len(cot)], leaves, cot,
                                 allow_unused=True)
        ga = [torch.zeros_like(t) if g is None else g
              for g, t in zip(ga, leaves)]
        case["rel_err_autograd"] = max(rel_err(g, w) for g, w in zip(got, ga))
        err = max(err, case["rel_err_autograd"])
        del leaves, ga, y, final
    iters = 5 if s > 256 else 10
    case["ms"] = time_ms(
        lambda: ops._ssd_bwd(*args, dy, dfinal, states, chunk), iters, 1)
    case["plain_ms"] = time_ms(lambda: ref.ssd_scan_bwd_ref(
        *args, dy, dfinal, chunk=chunk), iters, 1)
    case["bound_ms"], case["bound_by"] = bound(
        *_ssd_work((b, s, h, p, n), chunk, x.element_size(), True,
                   dfinal is not None), PEAK_FLOPS[dtype])
    emit(case)
    if not (err <= GRAD_TOL[dtype] and finite):
        fail(f"ssd_scan backward {label} {case['shape']} {dtype}: "
             f"rel err {err}")
    return case


def _to32(cache):
    """Every tensor of a (nested) cache in fp32, as the engine serves."""
    if isinstance(cache, torch.Tensor):
        return cache.float()
    if isinstance(cache, dict):
        return {k: _to32(v) for k, v in cache.items()}
    return tuple(_to32(v) for v in cache)


@torch.inference_mode()
def phase_model_parity(Model, get_arch, arch: str = "gemma-2b") -> None:
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    gpu = Model(cfg, dtype=torch.float32, device="cuda", generator=gen,
                trainable=False)
    cpu = copy.deepcopy(gpu).to("cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 136),
                         generator=torch.Generator().manual_seed(3))
    cache_len, prompt = 136, 128
    errs = []

    def rel(got, want):
        e = max_err(got.cpu(), want) / float(want.abs().max())
        errs.append(e)
        return e

    lg, cg = gpu.prefill({"tokens": toks[:, :prompt].cuda()}, cache_len)
    lc, cc = cpu.prefill({"tokens": toks[:, :prompt]}, cache_len)
    rel(lg, lc)
    cg, cc = _to32(cg), _to32(cc)
    for pos in range(prompt, prompt + 8):
        tok = toks[:, pos:pos + 1]
        lg, cg = gpu.decode_step(cg, tok.cuda(), pos)
        lc, cc = cpu.decode_step(cc, tok, pos)
        rel(lg, lc)
    emit({"phase": "model_parity", "arch": cfg.name, "n_layers": 2,
          "d_model": cfg.d_model, "dtype": "float32", "prompt": prompt,
          "rel_err_prefill": errs[0], "rel_err_decode": errs[1:],
          "max_rel_err": max(errs), "tol": MODEL_TOL})
    if not max(errs) <= MODEL_TOL:
        fail(f"model parity: relative error {max(errs)} > {MODEL_TOL}")


def _layer_counts(cfg) -> tuple[int, int]:
    """(attention layers, mamba layers)."""
    specs = cfg.layer_specs()
    return (sum(sp.mixer == "attn" for sp in specs),
            sum(sp.mixer == "mamba" for sp in specs))


def expected_serving_launches(cfg, n_new: int) -> dict:
    """Two norms a layer plus the final norm in the prefill and in each
    decode step; one flash attention or SSD scan a layer in the prefill
    (decode attends and scans in plain PyTorch)."""
    n_attn, n_mamba = _layer_counts(cfg)
    want = {"rms_norm": (2 * cfg.n_layers + 1) * (1 + n_new)}
    if n_attn:
        want["flash_attention"] = n_attn
    if n_mamba:
        want["ssd_scan"] = n_mamba
    return want


# the flash kernels of each route, by the names a profile gives them
FLASH_KERNELS = {
    "tensor_core": ("flash_tc_fwd", "flash_tc_dkdv", "flash_tc_combine",
                    "flash_tc_dq"),
    "cuda_core": ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"),
}


def check_flash_routes(ops, cfg, got: dict, fwd: int, bwd: int,
                       what: str) -> None:
    """bf16 attention at the models' head_dim runs the tensor-core flash
    kernels: ``fwd`` forward and ``bwd`` backward launches of them in a
    profiled window whose flash kernel launches are ``got``, and none of
    the CUDA-core ones."""
    route = ops.flash_route(torch.bfloat16, cfg.head_dim)
    tc = {"flash_tc_fwd": fwd, "flash_tc_dkdv": bwd, "flash_tc_dq": bwd}
    if (route != "tensor_core" or any(got[n] != c for n, c in tc.items())
            or any(got[n] for n in FLASH_KERNELS["cuda_core"])):
        fail(f"{what}: flash kernels {got} (route {route}), want {tc} and "
             f"no CUDA-core flash kernel: bf16 attention at head_dim "
             f"{cfg.head_dim} must run the tensor-core kernels")


def phase_serving(Model, ServeEngine, get_arch, ops,
                  arch: str = "gemma-2b") -> dict:
    cfg = get_arch(arch)
    batch, prompt, n_new = 8, 1024, 32
    gen = torch.Generator(device="cuda").manual_seed(4)
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", generator=gen,
                  trainable=False)
    eng = ServeEngine(model, max_len=prompt + n_new + 8)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=torch.Generator().manual_seed(4)).numpy()
    eng.generate({"tokens": toks[:, :64]}, 2)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = eng.generate({"tokens": toks}, n_new)
    launches = dict(ops.LAUNCHES)
    want = dict.fromkeys(launches, 0) | expected_serving_launches(cfg, n_new)
    in_range = bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
    emit({"phase": "serving", "arch": cfg.name, "n_layers": cfg.n_layers,
          "dtype": "bfloat16", "batch": batch, "prompt_len": prompt,
          "new_tokens": n_new, "n_params": model.n_params(),
          "prefill_ms": res.prefill_time_s * 1e3,
          "decode_ms": res.decode_time_s * 1e3,
          "decode_tok_per_s": res.tokens_per_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "expected_launches": want,
          "tokens_shape": list(res.tokens.shape), "ids_in_range": in_range,
          "sample_ids": res.tokens[0, :8].tolist()})
    if launches != want:
        fail(f"launches {launches} != {want}")
    if res.tokens.shape != (batch, n_new) or not in_range:
        fail(f"generated ids out of shape or range: {res.tokens.shape}")
    prefill = phase_profile(model, torch.from_numpy(toks).cuda(), eng.max_len)
    if want["flash_attention"]:
        check_flash_routes(ops, cfg, prefill["flash_kernels"],
                           want["flash_attention"], 0, "prefill")
    return launches


def _profile(fn) -> dict:
    """Device time by kernel and the device's idle share over one window.

    The wall clock includes the profiler's own overhead, so the idle
    share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in kern)
    top = sorted(kern, key=lambda kt: -kt[1])[:8]
    flash = {n: sum(c for k, _, c in kern if n + "<" in k or n + "(" in k)
             for names in FLASH_KERNELS.values() for n in names}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if busy else "not measured",
            "top_kernels_ms": [[k[:70], t] for k, t, _ in top],
            "flash_kernels": flash}


@torch.inference_mode()
def phase_profile(model, toks: torch.Tensor, cache_len: int) -> dict:
    """Profiles of a prefill and of 8 decode steps; returns the prefill's."""
    prefill = _profile(lambda: model.prefill({"tokens": toks}, cache_len))
    logits, cache = model.prefill({"tokens": toks}, cache_len)
    cache = _to32(cache)
    pos = toks.shape[1]

    def decode(steps=8):
        nonlocal logits, cache, pos
        for _ in range(steps):
            nxt = logits[:, -1].argmax(-1)[:, None]
            logits, cache = model.decode_step(cache, nxt, pos)
            pos += 1

    emit({"phase": "profile", "prefill": prefill,
          "decode_8_steps": _profile(decode)})
    return prefill


def _leaf_errs(got: dict, want: dict) -> float:
    """Largest error of any leaf, relative to the leaf's largest value."""
    return max(max_err(got[n].detach().cpu(), w)
               / max(float(w.float().abs().max()), 1e-30)
               for n, w in want.items())


def phase_train_parity(Model, AdamW, get_arch, arch: str = "gemma-2b") -> None:
    """One training step of a full-width, depth-2 fp32 model, card vs CPU
    copy: the loss, every gradient, and the params after one AdamW step.

    AdamW's first step is lr * g / (|g| + eps), about lr * sign(g): an
    element whose gradient is near zero takes a step whose sign the order
    of the sums decides, on any two backends.  So the step is held to the
    tolerance from the same gradients on both sides (the CPU's, copied to
    the card), and the step from each side's own gradients is reported."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(5)
    gpu = Model(cfg, dtype=torch.float32, device="cuda", generator=gen,
                remat=False)
    cpu = copy.deepcopy(gpu).to("cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(5))
    errs, losses = {}, []
    for model, t in ((gpu, toks.cuda()), (cpu, toks)):
        loss = model.loss({"tokens": t, "labels": t})
        loss.backward()
        losses.append(float(loss.detach()))
    grads = {n: p.grad for n, p in cpu.named_parameters()}
    errs["loss"] = abs(losses[0] - losses[1]) / abs(losses[1])
    errs["grads"] = _leaf_errs({n: p.grad for n, p in gpu.named_parameters()},
                               grads)
    opt = AdamW()
    cpu_p = dict(cpu.named_parameters())
    opt.update(grads, opt.init(cpu_p), cpu_p)
    want = {n: p.detach() for n, p in cpu_p.items()}
    gpu_p = dict(gpu.named_parameters())
    start = {n: p.detach().clone() for n, p in gpu_p.items()}
    opt.update({n: p.grad for n, p in gpu_p.items()}, opt.init(gpu_p), gpu_p)
    own = _leaf_errs(gpu_p, want)
    with torch.no_grad():
        for n, p in gpu_p.items():
            p.copy_(start[n])
    del start
    opt.update({n: g.cuda() for n, g in grads.items()}, opt.init(gpu_p), gpu_p)
    errs["params_after_step"] = _leaf_errs(gpu_p, want)
    emit({"phase": "train_parity", "arch": cfg.name, "n_layers": 2,
          "d_model": cfg.d_model, "dtype": "float32", "batch": 2, "seq": 64,
          "loss_card": losses[0], "loss_cpu": losses[1],
          "rel_err": errs, "tol": MODEL_TOL,
          "params_after_step_own_grads_rel_err": own})
    if not max(errs.values()) <= MODEL_TOL:
        fail(f"train parity: relative errors {errs} > {MODEL_TOL}")


def expected_train_launches(cfg) -> dict:
    """Per step with remat off: two norms a layer plus the final norm,
    one attention or SSD scan a layer, one fused loss; each forward and
    backward."""
    n = cfg.n_layers
    n_attn, n_mamba = _layer_counts(cfg)
    want = {"rms_norm": 2 * n + 1, "rms_norm_bwd": 2 * n + 1,
            "ce_loss": 1, "ce_loss_bwd": 1}
    if n_attn:
        want |= {"flash_attention": n_attn, "flash_attention_bwd": n_attn}
    if n_mamba:
        want |= {"ssd_scan": n_mamba, "ssd_scan_bwd": n_mamba}
    return want


def phase_training(Model, ElasticTrainer, get_arch, ops,
                   arch: str = "gemma-2b"):
    """A main path: the model at full width and depth, bf16, through the
    ElasticTrainer at the JAX trainer's defaults."""
    cfg = get_arch(arch)
    gen = torch.Generator(device="cuda").manual_seed(6)
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", generator=gen,
                  remat=False)
    tr = ElasticTrainer(model, per_node_batch=8, seed=6)
    want = dict.fromkeys(ops.LAUNCHES, 0) | expected_train_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    up_s = tr.rescale(1)
    steps, per_step, totals = [], [], dict.fromkeys(ops.LAUNCHES, 0)

    def step():
        ops.reset_launches()
        m = tr.train_step()
        launches = dict(ops.LAUNCHES)
        for k, c in launches.items():
            totals[k] += c
        steps.append(m)
        per_step.append(launches)

    for _ in range(6):
        step()
    before = {n: p.detach().clone() for n, p in tr.params.items()}
    park_s = tr.rescale(0)
    on_host = all(p.device.type == "cpu" for p in tr.params.values())
    unpark_s = tr.rescale(1)
    same = all(torch.equal(before[n], p.detach())
               for n, p in tr.params.items())
    del before
    for _ in range(2):
        step()
    ms = sorted(m.step_time_s * 1e3 for m in steps[1:6])
    step_ms = ms[len(ms) // 2]
    tokens = tr.per_node_batch * tr.pipeline.cfg.seq_len
    losses = [m.loss for m in steps]
    out = {"phase": "training", "arch": cfg.name, "n_layers": cfg.n_layers,
           "n_params": model.n_params(), "dtype": "bfloat16",
           "optimizer_state": "float32", "per_node_batch": tr.per_node_batch,
           "seq": tr.pipeline.cfg.seq_len, "remat": False,
           "step_ms_median_2_6": step_ms,
           "step_ms": [m.step_time_s * 1e3 for m in steps],
           "tokens_per_s": tokens / (step_ms / 1e3),
           "losses": losses,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "rescale_up_first_s": up_s, "park_s": park_s,
           "unpark_s": unpark_s, "params_on_host_when_parked": on_host,
           "params_bitwise_equal_across_park": same,
           "launches_per_step": per_step[-1], "expected_per_step": want,
           "launches_total": totals}
    emit(out)
    if not all(p == want for p in per_step):
        fail(f"training launches per step {per_step} != {want}")
    if not all(torch.isfinite(torch.tensor(losses))):
        fail(f"non-finite training loss {losses}")
    if not (same and on_host):
        fail("params changed across park/unpark or were not parked on host")
    prof = _profile(lambda: tr.train_step())
    emit({"phase": "profile", "training_step": prof})
    if want["flash_attention"]:
        check_flash_routes(ops, cfg, prof["flash_kernels"],
                           want["flash_attention"],
                           want["flash_attention_bwd"], "training step")
    return tr, per_step[-1], totals


def phase_elastic(tr, ops) -> dict:
    """The trainer under BFTrainerRuntime and the fast MILP over a replayed
    idle-node trace: each grant unparks it, each loss of nodes parks it."""
    from repro_torch.core import MILPAllocator, amdahl_curve, \
        fragments_to_events, generate_summit_like
    from repro_torch.elastic import BFTrainerRuntime, ManagedTrainer
    tr.rescale(0)
    first = len(tr.rescale_history)
    frags = generate_summit_like(n_nodes=6, duration=24 * 3600.0, seed=5)
    managed = [ManagedTrainer(id=0, trainer=tr,
                              curve=amdahl_curve("gemma-2b", 100.0, 0.2),
                              n_min=1, n_max=1, target_steps=4)]
    ops.reset_launches()
    rep = BFTrainerRuntime(managed, MILPAllocator("fast"), t_fwd=120.0).run(
        fragments_to_events(frags), time_scale=1.0, max_steps_per_interval=2)
    launches = dict(ops.LAUNCHES)
    walls = [list(h) for h in tr.rescale_history[first:]]
    out = {"phase": "elastic", "trace": "generate_summit_like(n_nodes=6, "
           "duration=24h, seed=5)", "allocator": "MILPAllocator('fast')",
           "events": rep.events, "steps": rep.steps[0],
           "rescales": rep.rescales[0] - first, "losses": rep.losses[0],
           "rescale_walls_s": walls,
           "r_up_r_dw_fed_to_milp": list(tr.measured_rescale_costs()),
           "solver_wall_s": rep.solver_wall_s, "wall_s": rep.wall_time_s,
           "launches": launches}
    emit(out)
    if rep.steps[0] < 1 or not walls:
        fail(f"elastic run took {rep.steps[0]} steps, {len(walls)} rescales")
    if not all(torch.isfinite(torch.tensor(rep.losses[0]))):
        fail(f"non-finite elastic loss {rep.losses[0]}")
    return out


KERNELS = [
    # name, source, replaces, the main path its timings and launches are
    # taken from
    ("rms_norm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:24",
     "mamba2-2.7b"),
    ("rms_norm_bwd", "rmsnorm.cu",
     "backward of src/repro/kernels/rmsnorm.py:24, no TPU counterpart",
     "mamba2-2.7b"),
    ("flash_attention", "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:76", "gemma-2b"),
    ("flash_attention_bwd", "flash_attention.cu",
     "backward of src/repro/kernels/flash_attention.py:76, no TPU "
     "counterpart", "gemma-2b"),
    ("ce_loss", "ce_loss.cu", "src/repro/kernels/ce_loss.py:64",
     "mamba2-2.7b"),
    ("ce_loss_bwd", "ce_loss.cu",
     "backward of src/repro/kernels/ce_loss.py:64, no TPU counterpart",
     "mamba2-2.7b"),
    ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:67",
     "mamba2-2.7b"),
    ("ssd_scan_bwd", "ssd_scan.cu",
     "backward of src/repro/kernels/ssd_scan.py:67, no TPU counterpart",
     "mamba2-2.7b"),
]


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.serving import ServeEngine

    smi = phase_device()
    phase_build(build)
    rms = phase_rms_norm(ops, ref)
    flash = phase_flash(ops, ref)
    ce = phase_ce_loss(ops, ref)
    ssd = phase_ssd_scan(ops, ref)
    # the kernels' cases at each main path's training shapes
    cases = {"gemma-2b": rms[2048] | flash | ce[256000],
             "mamba2-2.7b": rms[5120] | ce[50280] | ssd}
    _free()
    launches = {}
    for arch in ("gemma-2b", "mamba2-2.7b"):
        phase_model_parity(Model, get_arch, arch)
        _free()
        launches[f"serve-{arch}"] = phase_serving(Model, ServeEngine,
                                                  get_arch, ops, arch)
        _free()
        phase_train_parity(Model, AdamW, get_arch, arch)
        _free()
        tr, per_step, _ = phase_training(Model, ElasticTrainer, get_arch,
                                         ops, arch)
        launches[f"train-{arch}"] = per_step
        if arch == "gemma-2b":
            phase_elastic(tr, ops)
        del tr
        _free()

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": rep,
         "launches": launches[f"train-{path}"][name],
         "launches_by_path": {p: c[name] for p, c in launches.items()
                              if c[name]},
         "timed_on": f"{path} training shape",
         **{k: cases[path][name][k] for k in keys}}
        for name, src, rep, path in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
