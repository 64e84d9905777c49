#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the repository root; it puts ``src`` on ``sys.path`` itself and
imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line per case, in order; any failure ends the run with a non-zero
exit code:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc``, with
   ptxas' register and shared-memory report;
3. rms_norm: kernel vs its plain PyTorch version at gemma-2b's training
   (2048 rows), prefill (8*1024) and decode (8) shapes, d = 2048, fp32
   and bf16; the backward kernel at the training shape;
4. flash_attention: kernel vs its plain version at gemma-2b's training
   (B 8, H 8, KV 1, S 256, D 256) and prefill (S 1024) shapes and on
   small GQA cases with a window, a softcap, a ragged S and Sq != Sk;
   the backward kernels at the training shape and on the small cases;
5. ce_loss: the fused cross-entropy forward and backward at gemma-2b's
   training shape (T 2040, V 256000, d 2048, bf16) and in fp32 at
   T 77, V 1000, d 64;
6. model parity: gemma-2b at full width and depth 2, fp32, the model on
   the card (kernels) against a copy on the CPU (plain versions), prefill
   and 8 teacher-forced decode steps;
7. serving: gemma-2b at full width and depth in bf16 through
   ``ServeEngine.generate`` (8 requests, 1024 prompt tokens, 32 new),
   with the kernel launch counts of that run, and a profile;
8. train parity: gemma-2b at full width and depth 2, fp32, batch 2 x 64:
   loss, every gradient and the params after one AdamW step, the card
   against a CPU copy;
9. training (the main path): gemma-2b at full width and depth, bf16
   params with fp32 AdamW state, through ``ElasticTrainer`` at the JAX
   trainer's defaults (per-node batch 8, seq 256): rescale(1), 6 steps,
   park, unpark, 2 steps, with the launches of every step, then one
   profiled step;
10. elastic: that trainer under ``BFTrainerRuntime`` with the fast MILP
    allocator over a replayed idle-node trace;
11. a ``kernels`` line: each kernel's launches in one training step,
    error, times and bound at the training shapes, in bf16.

Tolerances: kernels 2e-5 (fp32) / 2e-2 (bf16), those of the JAX
package's kernel tests; a bf16 output is held to 2e-2 of
max(|plain|, 1) elementwise, one bf16 ulp with margin.  Gradients: 1e-4
(fp32) / 2e-2 (bf16) of the largest |gradient|.  Model and train parity
1e-3 of the largest value of each output or leaf: fp32 with TF32 off
(set below for matmuls and cuDNN), so the card and the CPU differ only
in the order sums are taken.  Times are CUDA-event means over repeated
launches after a warm-up; the inputs are not flushed from L2 between
launches, as the model's caller finds them freshly written.  Bounds use
the H100 SXM data-sheet peaks: 3.35 TB/s of HBM, 989 TFLOP/s in bf16 on
the tensor cores and 67 TFLOP/s in fp32 without them.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODEL_TOL = 1e-3
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


def out_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The error a forward output is held to: absolute in fp32; in bf16
    relative to max(|want|, 1) elementwise (one bf16 ulp is 2**-8 of the
    value, so an absolute bound fails on outputs of 4 or more)."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        diff = diff / want.float().abs().clamp(min=1.0)
    return float(diff.max())


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


def phase_build(build) -> None:
    t0 = time.perf_counter()
    build.build(force=True)
    build.library()
    seconds = time.perf_counter() - t0
    ptxas, fn = {}, ""
    for ln in build.BUILD_LOG.splitlines():       # registers per kernel
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill stores" in ln or "Used" in ln:
            ptxas[fn] = (ptxas.get(fn, "") + " " + ln.strip()).strip()
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def phase_rms_norm(ops, ref) -> dict:
    """Forward at the training, prefill and decode shapes; backward at the
    training shape.  Returns the bf16 cases at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    main = {}
    d = 2048
    for rows in (2048, 8 * 1024, 8):
        for dtype in (torch.float32, torch.bfloat16):
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
            if rows == 2048 and dtype == torch.bfloat16:
                main["rms_norm"] = case
            if rows == 2048:
                bwd = _rms_norm_bwd_case(ops, ref, x, s, gen)
                if dtype == torch.bfloat16:
                    main["rms_norm_bwd"] = bwd
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
            got = ops.flash_attention(q, k, v, **kw)
            err = out_err(got, want)
            case = {
                "phase": "flash_attention", "shape": [b, h, kv, sq, sk, d],
                "dtype": dt_name(dtype), **kw,
                "max_abs_err": max_err(got, want), "err": err,
                "tol": TOL[dtype],
                "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                "plain_ms": time_ms(
                    lambda: ref.flash_attention_ref(q, k, v, **kw)),
                "library_ms": None,
            }
            sdpa = causal and not window and not cap and sq == sk
            if sdpa:
                ke = k.repeat_interleave(h // kv, dim=1)
                ve = v.repeat_interleave(h // kv, dim=1)
                case["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                           is_causal=True))
            pairs = _pairs(sq, sk, causal, window)
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            case["bound_ms"], case["bound_by"] = bound(
                nbytes, 4 * d * b * h * pairs, PEAK_FLOPS[dtype])
            emit(case)
            if not err <= TOL[dtype]:
                fail(f"flash_attention {case['shape']} {kw} {dtype}: err {err}")
            if sq == 1024:
                continue
            bwd = _flash_bwd_case(ops, ref, q, k, v, got, kw, pairs, gen,
                                  sdpa)
            if sq == 256 and d == 256 and dtype == torch.bfloat16:
                main["flash_attention"], main["flash_attention_bwd"] = case, bwd
    return main


def _flash_bwd_case(ops, ref, q, k, v, o, kw, pairs, gen, sdpa) -> dict:
    b, h, sq, d = q.shape
    kv, dtype = k.shape[1], q.dtype
    scale = d ** -0.5
    args = (kw["causal"], kw["window"], kw["logit_cap"], scale)
    do = (torch.randn(q.shape, generator=gen, device="cuda") * 0.3).to(dtype)
    _, lse = ops._flash_fwd(q, k, v, *args, True)
    got = ops._flash_bwd(q, k, v, o, lse, do, *args)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    err = max(rel_err(g, w) for g, w in zip(got, want))
    case = {"phase": "flash_attention_bwd",
            "shape": [b, h, kv, sq, k.shape[2], d], "dtype": dt_name(dtype),
            **kw,
            "max_abs_err": max(max_err(g, w) for g, w in zip(got, want)),
            "rel_err": err, "tol": GRAD_TOL[dtype], "library_ms": None}
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
        case["library_ms"] = _grad_time(
            F.scaled_dot_product_attention(ql, kl, vl, is_causal=True),
            (ql, kl, vl), do)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * b * h * sq
    case["bound_ms"], case["bound_by"] = bound(
        nbytes, 10 * d * b * h * pairs, PEAK_FLOPS[dtype])
    emit(case)
    if not err <= GRAD_TOL[dtype]:
        fail(f"flash_attention backward {case['shape']} {kw} {dtype}: "
             f"rel err {err}")
    return case


CE_CASES = [
    # (T, V, d, dtype)
    (2040, 256000, 2048, torch.bfloat16),   # gemma-2b training: 8 x 255
    (77, 1000, 64, torch.float32),
]


def phase_ce_loss(ops, ref) -> dict:
    """Forward and backward; returns the training-shape cases."""
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
        emit(fwd)
        if not err <= TOL[dtype]:
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
            main["ce_loss"], main["ce_loss_bwd"] = fwd, bwd
        del x, w, dx, dw
        torch.cuda.empty_cache()
    return main


@torch.inference_mode()
def phase_model_parity(Model, get_arch) -> None:
    cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=2)
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
    to32 = lambda cache: tuple(  # noqa: E731
        {"kv": {n: t.float() for n, t in c["kv"].items()}} for c in cache)
    cg, cc = to32(cg), to32(cc)
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


def phase_serving(Model, ServeEngine, get_arch, ops) -> dict:
    cfg = get_arch("gemma-2b")
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
    want = dict.fromkeys(launches, 0) | {
        "rms_norm": (2 * cfg.n_layers + 1) * (1 + n_new),
        "flash_attention": cfg.n_layers}
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
    phase_profile(model, torch.from_numpy(toks).cuda(), eng.max_len)
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
    kern = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy = sum(t for _, t in kern)
    top = sorted(kern, key=lambda kt: -kt[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if busy else "not measured",
            "top_kernels_ms": [[k[:70], t] for k, t in top]}


@torch.inference_mode()
def phase_profile(model, toks: torch.Tensor, cache_len: int) -> None:
    prefill = _profile(lambda: model.prefill({"tokens": toks}, cache_len))
    logits, cache = model.prefill({"tokens": toks}, cache_len)
    cache = tuple({"kv": {n: t.float() for n, t in c["kv"].items()}}
                  for c in cache)
    pos = toks.shape[1]

    def decode(steps=8):
        nonlocal logits, cache, pos
        for _ in range(steps):
            nxt = logits[:, -1].argmax(-1)[:, None]
            logits, cache = model.decode_step(cache, nxt, pos)
            pos += 1

    emit({"phase": "profile", "prefill": prefill,
          "decode_8_steps": _profile(decode)})


def _leaf_errs(got: dict, want: dict) -> float:
    """Largest error of any leaf, relative to the leaf's largest value."""
    return max(max_err(got[n].detach().cpu(), w)
               / max(float(w.float().abs().max()), 1e-30)
               for n, w in want.items())


def phase_train_parity(Model, AdamW, get_arch) -> None:
    """One training step of a full-width, depth-2 fp32 model, card vs CPU
    copy: the loss, every gradient, and the params after one AdamW step.

    AdamW's first step is lr * g / (|g| + eps), about lr * sign(g): an
    element whose gradient is near zero takes a step whose sign the order
    of the sums decides, on any two backends.  So the step is held to the
    tolerance from the same gradients on both sides (the CPU's, copied to
    the card), and the step from each side's own gradients is reported."""
    cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=2)
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
    one attention a layer, one fused loss; each forward and backward."""
    n = cfg.n_layers
    return {"rms_norm": 2 * n + 1, "rms_norm_bwd": 2 * n + 1,
            "flash_attention": n, "flash_attention_bwd": n,
            "ce_loss": 1, "ce_loss_bwd": 1}


def phase_training(Model, ElasticTrainer, get_arch, ops):
    """The main path: gemma-2b, full width and depth, bf16, through the
    ElasticTrainer at the JAX trainer's defaults."""
    cfg = get_arch("gemma-2b")
    gen = torch.Generator(device="cuda").manual_seed(6)
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", generator=gen,
                  remat=False)
    tr = ElasticTrainer(model, per_node_batch=8, seed=6)
    want = expected_train_launches(cfg)
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
    # name, source, replaces
    ("rms_norm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:24"),
    ("rms_norm_bwd", "rmsnorm.cu",
     "backward of src/repro/kernels/rmsnorm.py:24, no TPU counterpart"),
    ("flash_attention", "flash_attention.cu",
     "src/repro/kernels/flash_attention.py:76"),
    ("flash_attention_bwd", "flash_attention.cu",
     "backward of src/repro/kernels/flash_attention.py:76, no TPU "
     "counterpart"),
    ("ce_loss", "ce_loss.cu", "src/repro/kernels/ce_loss.py:64"),
    ("ce_loss_bwd", "ce_loss.cu",
     "backward of src/repro/kernels/ce_loss.py:64, no TPU counterpart"),
]


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
    cases = phase_rms_norm(ops, ref)
    cases |= phase_flash(ops, ref)
    cases |= phase_ce_loss(ops, ref)
    phase_model_parity(Model, get_arch)
    torch.cuda.empty_cache()
    serving = phase_serving(Model, ServeEngine, get_arch, ops)
    torch.cuda.empty_cache()
    phase_train_parity(Model, AdamW, get_arch)
    torch.cuda.empty_cache()
    tr, per_step, _ = phase_training(Model, ElasticTrainer, get_arch, ops)
    phase_elastic(tr, ops)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": rep,
         "launches": per_step[name], "serving_launches": serving[name],
         **{k: cases[name][k] for k in keys}}
        for name, src, rep in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
