#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the repository root; it puts ``src`` on ``sys.path`` itself and
imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line, in order; any failure ends the run with a non-zero exit code:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc``, with
   ptxas' register and shared-memory report;
3. rms_norm: kernel vs its plain PyTorch version at gemma-2b's prefill
   (8*1024 rows) and decode (8 rows) shapes, d = 2048, fp32 and bf16;
4. flash_attention: kernel vs its plain version at gemma-2b's prefill
   shape (B 8, H 8, KV 1, S 1024, D 256, causal) and on small GQA cases
   with a window, a softcap, a ragged S and Sq != Sk;
5. model parity: gemma-2b at full width and depth 2, fp32, the model on
   the card (kernels) against a copy on the CPU (plain versions), prefill
   and 8 teacher-forced decode steps;
6. serving: gemma-2b at full width and depth in bf16 through
   ``ServeEngine.generate`` (8 requests, 1024 prompt tokens, 32 new),
   with the kernel launch counts of that run;
7. a ``kernels`` line: each kernel's launches in phase 6, error, times
   and bound at the main path's shape.

Tolerances: kernels 2e-5 (fp32) / 2e-2 (bf16), those of the JAX package's
kernel tests.  Model parity 1e-3 of the largest logit: fp32 with TF32 off
(set below for matmuls and cuDNN), so the card and the CPU differ only in
the order sums are taken.  Times are CUDA-event means over repeated
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
    gen = torch.Generator(device="cuda").manual_seed(1)
    main = None
    for rows in (8 * 1024, 8):
        for dtype in (torch.float32, torch.bfloat16):
            d = 2048
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            s = torch.randn(d, generator=gen, device="cuda") * 0.1
            err = max_err(ops.rms_norm(x, s), ref.rms_norm_ref(x, s))
            w = (1.0 + s).to(dtype)
            case = {
                "phase": "rms_norm", "rows": rows, "d": d,
                "dtype": str(dtype).removeprefix("torch."),
                "max_abs_err": err, "tol": TOL[dtype],
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
            if rows > 8 and dtype == torch.bfloat16:
                main = case
    return main


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
    (8, 8, 1, 1024, 1024, 256, True, 0, 0.0),     # gemma-2b prefill
    (2, 4, 2, 256, 256, 128, True, 64, 0.0),      # GQA + window
    (2, 4, 2, 256, 256, 64, True, 0, 50.0),       # GQA + softcap
    (2, 4, 2, 160, 160, 32, True, 0, 0.0),        # ragged S
    (1, 2, 1, 130, 190, 32, False, 0, 0.0),       # Sq != Sk, not causal
]


def phase_flash(ops, ref) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    main = None
    for b, h, kv, sq, sk, d, causal, window, cap in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape):
                return (torch.randn(*shape, generator=gen, device="cuda")
                        * 0.3).to(dtype)
            q, k, v = rnd(b, h, sq, d), rnd(b, kv, sk, d), rnd(b, kv, sk, d)
            kw = dict(causal=causal, window=window, logit_cap=cap)
            err = max_err(ops.flash_attention(q, k, v, **kw),
                          ref.flash_attention_ref(q, k, v, **kw))
            case = {
                "phase": "flash_attention", "shape": [b, h, kv, sq, sk, d],
                "dtype": str(dtype).removeprefix("torch."), **kw,
                "max_abs_err": err, "tol": TOL[dtype],
                "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
                "plain_ms": time_ms(
                    lambda: ref.flash_attention_ref(q, k, v, **kw)),
                "library_ms": None,
            }
            if causal and not window and not cap and sq == sk:
                ke = k.repeat_interleave(h // kv, dim=1)
                ve = v.repeat_interleave(h // kv, dim=1)
                case["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                           is_causal=True))
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            flops = 4 * d * b * h * _pairs(sq, sk, causal, window)
            case["bound_ms"], case["bound_by"] = bound(nbytes, flops,
                                                       PEAK_FLOPS[dtype])
            emit(case)
            if not err <= TOL[dtype]:
                fail(f"flash_attention {case['shape']} {kw} {dtype}: err {err}")
            if sq == 1024 and dtype == torch.bfloat16:
                main = case
    return main


def phase_model_parity(Model, get_arch) -> None:
    cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    gpu = Model(cfg, dtype=torch.float32, device="cuda", generator=gen)
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
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", generator=gen)
    eng = ServeEngine(model, max_len=prompt + n_new + 8)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=torch.Generator().manual_seed(4)).numpy()
    eng.generate({"tokens": toks[:, :64]}, 2)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = eng.generate({"tokens": toks}, n_new)
    launches = dict(ops.LAUNCHES)
    want = {"rms_norm": (2 * cfg.n_layers + 1) * (1 + n_new),
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


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import Model
    from repro_torch.serving import ServeEngine

    smi = phase_device()
    phase_build(build)
    rms = phase_rms_norm(ops, ref)
    fa = phase_flash(ops, ref)
    phase_model_parity(Model, get_arch)
    torch.cuda.empty_cache()
    launches = phase_serving(Model, ServeEngine, get_arch, ops)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": "rms_norm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:24",
         "launches": launches["rms_norm"], **{k: rms[k] for k in keys}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:76",
         "launches": launches["flash_attention"], **{k: fa[k] for k in keys}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
