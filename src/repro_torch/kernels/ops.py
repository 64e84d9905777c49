"""Dispatching wrappers for the hand-written kernels.

Counterparts of ``repro.kernels.ops``.  A tensor on the CPU goes to the
plain PyTorch version in ``ref``, differentiated by autograd; a CUDA
tensor goes to the CUDA kernel, or the call raises: there is no
fallback.  On the card each wrapper is a ``torch.autograd.Function``
whose forward and backward are both kernels; when no gradient is wanted
(serving, ``inference_mode``) the forward kernel runs alone and saves
nothing.  Both paths check the inputs against what the kernel takes
(dtype, shape, contiguity), so the CPU tests catch a layout the kernel
would refuse.  ``LAUNCHES`` counts the kernel calls (never the
plain-version calls), one per forward and one per backward, so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ce_loss_ref, flash_attention_ref, \
    rms_norm_ref, ssd_chunked

LAUNCHES: dict[str, int] = {
    "rms_norm": 0, "rms_norm_bwd": 0,
    "flash_attention": 0, "flash_attention_bwd": 0,
    "ce_loss": 0, "ce_loss_bwd": 0,
    "ssd_scan": 0, "ssd_scan_bwd": 0,
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
FLASH_TC_HEAD_DIMS = (64, 128, 256)   # flash_attention.cu, namespace fa
FLASH_TILE = 64         # keys a tile of the tensor-core dK/dV kernel
CE_MAX_DIM = 4096       # ce_loss.cu, fp32 kernels: d <= 8 x 512 threads
CE_TILE = 128           # ce_loss.cu, bf16: output tile rows
CE_VTILE = 256          # ce_loss.cu, bf16 forward: vocab columns a tile
CE_CHUNK = 32768        # bf16 backward: vocab rows a chunk (P <= 128 MiB
                        # of bf16 scratch at T 2048)
SSD_MAX_P, SSD_MAX_N, SSD_MAX_CHUNK = 64, 128, 256   # ssd_scan.cu tiles


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return True


def _check(what: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _stream() -> int:
    """PyTorch's current CUDA stream, as the handle the launchers take."""
    return torch.cuda.current_stream().cuda_stream


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors only; each counts one launch)
# ---------------------------------------------------------------------------


def _rms_norm_fwd(x, scale, eps):
    out = torch.empty_like(x)
    d = x.shape[-1]
    build.check(build.library().rms_norm_launch(
        out.data_ptr(), x.data_ptr(), scale.data_ptr(), x.numel() // max(d, 1),
        d, eps, _DTYPES[x.dtype], _stream()), "rms_norm")
    LAUNCHES["rms_norm"] += 1
    return out


def _rms_norm_bwd(x, scale, dy, eps):
    lib = build.library()
    d = x.shape[-1]
    rows = x.numel() // max(d, 1)
    per = lib.rms_norm_bwd_rows_per_block()
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    part = torch.empty(max(1, -(-rows // per)), d, dtype=torch.float32,
                       device=x.device)
    build.check(lib.rms_norm_bwd_launch(
        dx.data_ptr(), dscale.data_ptr(), part.data_ptr(), x.data_ptr(),
        scale.data_ptr(), dy.data_ptr(), rows, d, eps, _DTYPES[x.dtype],
        _stream()), "rms_norm_bwd")
    LAUNCHES["rms_norm_bwd"] += 1
    return dx, dscale


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which flash kernels a call runs, from the dtype and head_dim alone:
    "tensor_core" (wgmma, TMA) for bf16 at head_dim 64, 128 or 256;
    "cuda_core" (the first, fp32-product kernels) for fp32, which the
    parity checks hold to 2e-5 / 1e-4, and for bf16 at any other head_dim
    (the tensor-core kernels are instantiated for those three only)."""
    return ("tensor_core" if dtype == torch.bfloat16
            and head_dim in FLASH_TC_HEAD_DIMS else "cuda_core")


def flash_dkdv_splits(b: int, kv: int, sk: int, group: int, sms: int) -> int:
    """Head splits of the tensor-core dK/dV kernel: its blocks are (b * kv
    + kv head, split, 64-key tile), so about two blocks an SM on ``sms``
    SMs, at most one split a query head of the ``group``."""
    blocks = b * kv * -(-sk // FLASH_TILE)
    return max(1, min(group, round(2 * sms / blocks)))


def _flash_fwd(q, k, v, causal, window, logit_cap, scale, want_lse):
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    route = flash_route(q.dtype, d)
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    build.check(build.library().flash_attention_launch(
        out.data_ptr(), _ptr(lse), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        b, h, kv, sq, sk, d, scale, int(causal), int(window),
        float(logit_cap), _DTYPES[q.dtype], int(route == "tensor_core"),
        _stream()), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def _flash_bwd(q, k, v, o, lse, do, causal, window, logit_cap, scale):
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    route = flash_route(q.dtype, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    splits, part = 1, None
    if route == "tensor_core":
        if do.data_ptr() % 16:          # TMA reads 16-byte-aligned bases
            do = do.clone()
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = flash_dkdv_splits(b, kv, sk, h // kv, sms)
        if splits > 1:
            part = torch.empty(2, splits, b * kv * sk * d,
                               dtype=torch.float32, device=q.device)
    build.check(build.library().flash_attention_bwd_launch(
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        _ptr(part), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), b, h, kv, sq, sk, d, scale,
        int(causal), int(window), float(logit_cap), _DTYPES[q.dtype],
        int(route == "tensor_core"), splits, _stream()),
        "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def ce_splits(rows: int, vocab: int, sms: int) -> int:
    """Vocabulary splits of the bf16 forward: about four waves of blocks
    of 128 token rows on ``sms`` SMs, at least one 256-row vocab tile a
    split."""
    ttiles, vtiles = -(-rows // CE_TILE), -(-vocab // CE_VTILE)
    return max(1, min(vtiles, round(4 * sms / ttiles)))


def ce_chunk(vocab: int) -> int:
    """Vocabulary rows a bf16 backward chunk: ``CE_CHUNK``, or the vocab
    rounded up to a tile when it is smaller."""
    return min(CE_CHUNK, -(-vocab // CE_TILE) * CE_TILE)


def _ce_fwd(x, table, labels):
    t, d = x.shape
    v = table.shape[0]
    loss = torch.empty(t, dtype=torch.float32, device=x.device)
    logz = torch.empty(t, dtype=torch.float32, device=x.device)
    splits, part = 0, None
    if x.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = ce_splits(t, v, sms)
        part = torch.empty(t, splits, 3, dtype=torch.float32, device=x.device)
    build.check(build.library().ce_loss_fwd_launch(
        loss.data_ptr(), logz.data_ptr(), _ptr(part), x.data_ptr(),
        table.data_ptr(), labels.data_ptr(), t, v, d, splits,
        _DTYPES[x.dtype], _stream()), "ce_loss")
    LAUNCHES["ce_loss"] += 1
    return loss, logz


def _ce_bwd(x, table, labels, logz, g):
    t, d = x.shape
    v = table.shape[0]
    dx, dw = torch.empty_like(x), torch.empty_like(table)
    chunk, pbuf, acc = 0, None, None
    if x.dtype == torch.bfloat16:
        chunk = ce_chunk(v)
        pbuf = torch.empty(t, chunk, dtype=torch.bfloat16, device=x.device)
        if v > chunk:
            acc = torch.empty(t, d, dtype=torch.float32, device=x.device)
    build.check(build.library().ce_loss_bwd_launch(
        dx.data_ptr(), dw.data_ptr(), _ptr(pbuf), _ptr(acc), x.data_ptr(),
        table.data_ptr(), labels.data_ptr(), logz.data_ptr(), g.data_ptr(),
        t, v, d, chunk, _DTYPES[x.dtype], _stream()), "ce_loss_bwd")
    LAUNCHES["ce_loss_bwd"] += 1
    return dx, dw


def ce_tile_product(a: torch.Tensor, b: torch.Tensor,
                    layout: str) -> torch.Tensor:
    """The bf16 ``ce_loss`` kernels' tensor-core tile engine alone, for its
    tests: fp32 ``a @ b.T`` (layout "NT": a (m, k), b (n, k)), ``a.T @ b``
    ("TN": a (k, m), b (k, n)) or ``a @ b`` ("NN": a (m, k), b (k, n)).
    Not counted in ``LAUNCHES``: no model path calls it."""
    _check("ce_tile_product", _on_cuda(a, "ce_tile_product"),
           "runs on the card only")
    code = {"NT": 0, "TN": 1, "NN": 2}[layout]
    m = a.shape[1] if layout == "TN" else a.shape[0]
    n = b.shape[0] if layout == "NT" else b.shape[1]
    k = a.shape[0] if layout == "TN" else a.shape[1]
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    build.check(build.library().ce_tile_product_launch(
        out.data_ptr(), a.data_ptr(), b.data_ptr(), m, n, k, code,
        _stream()), "ce_tile_product")
    return out


def _ssd_fwd(x, dt, a, bmat, cmat, chunk, want_states):
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = -(-s // chunk)
    y = torch.empty_like(x)
    final = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    states = (torch.empty(b, h, nc - 1, p, n, dtype=torch.float32,
                          device=x.device)
              if want_states and nc > 1 else None)
    build.check(build.library().ssd_scan_launch(
        y.data_ptr(), final.data_ptr(), _ptr(states), x.data_ptr(),
        dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        b, s, h, p, n, chunk, _DTYPES[x.dtype], _stream()), "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, final, states


def _ssd_bwd(x, dt, a, bmat, cmat, dy, dfinal, states, chunk):
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    dx, dbm, dcm = (torch.empty_like(t) for t in (x, bmat, cmat))
    ddt = torch.empty_like(dt)
    da = torch.empty_like(a)
    part = torch.empty(b, h, dtype=torch.float32, device=x.device)
    build.check(build.library().ssd_scan_bwd_launch(
        dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), part.data_ptr(),
        dbm.data_ptr(), dcm.data_ptr(), x.data_ptr(), dt.data_ptr(),
        a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dy.data_ptr(),
        _ptr(dfinal), _ptr(states), b, s, h, p, n, chunk, _DTYPES[x.dtype],
        _stream()), "ssd_scan_bwd")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, da, dbm, dcm


# ---------------------------------------------------------------------------
# Autograd: kernel forward, kernel backward
# ---------------------------------------------------------------------------


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _rms_norm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, scale):
        out, lse = _flash_fwd(q, k, v, causal, window, logit_cap, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, logit_cap, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


class _CeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, labels):
        loss, logz = _ce_fwd(x, table, labels)
        ctx.save_for_backward(x, table, labels, logz)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, table, labels, logz = ctx.saved_tensors
        dx, dw = _ce_bwd(x, table, labels, logz, g.float().contiguous())
        return dx, dw, None


class _SsdScan(torch.autograd.Function):
    """(y, final_state); the backward takes a cotangent for either output
    (None: zero) and seeds the reverse carry with final_state's."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk):
        y, final, states = _ssd_fwd(x, dt, a, bmat, cmat, chunk, True)
        ctx.save_for_backward(x, dt, a, bmat, cmat, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, bmat, cmat, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dfinal = None if dfinal is None else dfinal.float().contiguous()
        grads = _ssd_bwd(x, dt, a, bmat, cmat, dy, dfinal, states,
                         ctx.chunk)
        return (*grads, None)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) fp32 or bf16; scale: (d,) fp32. Returns x's dtype/shape."""
    what = "rms_norm"
    on_cuda = _on_cuda(x, what)
    d = x.shape[-1]
    _check(what, x.dtype in _DTYPES, f"dtype {x.dtype} not supported")
    _check(what, scale.dtype == torch.float32 and scale.shape == (d,),
           f"scale must be fp32 of shape ({d},), got {scale.dtype} "
           f"{tuple(scale.shape)}")
    _check(what, scale.device == x.device, "x and scale on different devices")
    _check(what, x.is_contiguous() and scale.is_contiguous(),
           "inputs must be contiguous")
    if not on_cuda:
        return rms_norm_ref(x, scale, eps)
    if _wants_grad(x, scale):
        return _RmsNorm.apply(x, scale, eps)
    return _rms_norm_fwd(x, scale, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,KV,Sk,D); H % KV == 0. Returns (B,H,Sq,D).

    On the card, bf16 at head_dim 64, 128 or 256 runs the tensor-core
    kernels, which need 16-byte-aligned bases and Sk > 0; fp32, and bf16
    at any other head_dim, the CUDA-core kernels (``flash_route``).  The
    JAX wrapper's ``block_q``/``block_k``/``interpret`` have no
    counterpart: the CUDA kernels' tiles are fixed (see their source).
    """
    what = "flash_attention"
    on_cuda = _on_cuda(q, what)
    _check(what, q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "q, k, v must be 4-d")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    _check(what, k.shape == v.shape == (b, kv, sk, d),
           f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
           f"{tuple(q.shape)}")
    _check(what, kv > 0 and h % kv == 0, f"H={h} not a multiple of KV={kv}")
    _check(what, 0 < d <= MAX_HEAD_DIM, f"head_dim {d} > {MAX_HEAD_DIM}")
    _check(what, q.dtype in _DTYPES and k.dtype == q.dtype == v.dtype,
           f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported")
    _check(what, k.device == q.device == v.device, "tensors on different devices")
    _check(what, q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
           "inputs must be contiguous")
    _check(what, h <= 65535 and b <= 65535, "grid too large")
    if not on_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, scale=scale)
    if flash_route(q.dtype, d) == "tensor_core":     # TMA
        _check(what, sk > 0, "the tensor-core kernels need Sk > 0")
        _check(what, all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
               "q, k and v must start on 16-byte boundaries")
    scale = d ** -0.5 if scale is None else scale
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, logit_cap,
                                     scale)
    return _flash_fwd(q, k, v, causal, window, logit_cap, scale, False)[0]


def ce_loss(x: torch.Tensor, table: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy of the logits ``x @ table.T``, without
    materialising them. x: (T, d); table: (V, d), both fp32 or both bf16;
    labels: (T,) integer in [0, V). Returns (T,) fp32 ``logZ - gold``
    (mean-reduce outside). bf16 needs d % 8 == 0 (fp32: d <= 4096). The
    JAX wrapper's ``block_rows``/``block_v``/``interpret`` have no
    counterpart: the CUDA kernels' tiles are fixed.
    """
    what = "ce_loss"
    on_cuda = _on_cuda(x, what)
    _check(what, x.dim() == 2 and table.dim() == 2
           and table.shape[1] == x.shape[1],
           f"x {tuple(x.shape)} and table {tuple(table.shape)} must be "
           "(T, d) and (V, d)")
    t, d = x.shape
    _check(what, labels.shape == (t,) and not labels.is_floating_point()
           and not labels.is_complex(),
           f"labels must be integer of shape ({t},), got {labels.dtype} "
           f"{tuple(labels.shape)}")
    _check(what, x.dtype in _DTYPES and table.dtype == x.dtype,
           f"dtypes {x.dtype}/{table.dtype} not supported")
    _check(what, table.device == x.device == labels.device,
           "tensors on different devices")
    _check(what, x.is_contiguous() and table.is_contiguous(),
           "inputs must be contiguous")
    if x.dtype == torch.float32:
        _check(what, 0 < d <= CE_MAX_DIM, f"d_model {d} > {CE_MAX_DIM}")
    else:           # TMA: 16-byte row strides and bases
        _check(what, d > 0 and d % 8 == 0,
               f"bf16 d_model {d} must be a positive multiple of 8")
    _check(what, t < 2 ** 31 and table.shape[0] < 2 ** 31, "too many rows")
    if not on_cuda:
        return ce_loss_ref(x, table, labels)
    labels = labels.to(torch.int32).contiguous()
    _check(what, x.data_ptr() % 16 == 0 and table.data_ptr() % 16 == 0,
           "x and table must start on 16-byte boundaries")
    if _wants_grad(x, table):
        return _CeLoss.apply(x, table, labels)
    return _ce_fwd(x, table, labels)[0]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *,
             chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD chunked scan. x: (B,S,H,P); dt: (B,S,H) fp32; a: (H,)
    fp32; bmat, cmat: (B,S,H,N) in x's type (fp32 or bf16).  Returns (y
    (B,S,H,P) in x's type, final_state (B,H,P,N) fp32).  Any S: the kernel
    masks the last chunk instead of asking for a multiple of ``chunk``.
    The JAX wrapper's ``interpret`` has no counterpart."""
    what = "ssd_scan"
    on_cuda = _on_cuda(x, what)
    _check(what, x.dim() == 4, f"x must be (B,S,H,P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bmat.shape[-1] if bmat.dim() == 4 else -1
    _check(what, bmat.shape == cmat.shape == (b, s, h, n),
           f"bmat {tuple(bmat.shape)} / cmat {tuple(cmat.shape)} must be "
           f"(B,S,H,N) = ({b}, {s}, {h}, N)")
    _check(what, dt.shape == (b, s, h) and a.shape == (h,),
           f"dt {tuple(dt.shape)} / a {tuple(a.shape)} must be ({b}, {s}, "
           f"{h}) / ({h},)")
    _check(what, x.dtype in _DTYPES and bmat.dtype == cmat.dtype == x.dtype,
           f"dtypes {x.dtype}/{bmat.dtype}/{cmat.dtype} not supported")
    _check(what, dt.dtype == a.dtype == torch.float32,
           f"dt and a must be fp32, got {dt.dtype}/{a.dtype}")
    _check(what, x.device == dt.device == a.device == bmat.device
           == cmat.device, "tensors on different devices")
    _check(what, all(t.is_contiguous() for t in (x, dt, a, bmat, cmat)),
           "inputs must be contiguous")
    _check(what, s > 0 and 0 < p <= SSD_MAX_P and 0 < n <= SSD_MAX_N,
           f"S {s}, P {p}, N {n}: need S > 0, P <= {SSD_MAX_P}, "
           f"N <= {SSD_MAX_N}")
    _check(what, 0 < chunk <= SSD_MAX_CHUNK,
           f"chunk {chunk} not in (0, {SSD_MAX_CHUNK}]")
    if not on_cuda:
        return ssd_chunked(x, dt, a, bmat, cmat, chunk=chunk)
    if _wants_grad(x, dt, a, bmat, cmat):
        return _SsdScan.apply(x, dt, a, bmat, cmat, chunk)
    y, final, _ = _ssd_fwd(x, dt, a, bmat, cmat, chunk, False)
    return y, final
