"""Plain PyTorch versions of the hand-written kernels.

The forwards compute what ``repro.kernels.ref`` computes, step for step
and with the same roundings, so that they are both the CPU path of
``repro_torch.kernels.ops`` and the yardstick each CUDA kernel is held
against on the card.  The backwards (``*_bwd_ref``) are the explicit
formulas the backward kernels compute, in fp32, from the forward's inputs
and the statistics the forward kernels save (``lse``, ``logz``); they let
the algorithm be tested on the CPU against autograd and ``jax.grad``.

The SSD scan has two plain versions: ``ssd_scan_ref``, the naive
recurrence over S (the exact oracle, which cannot overflow), and
``ssd_chunked``, the chunked algorithm the model runs on the CPU.  Unlike
the JAX ``ssd_chunked``, which exponentiates the whole L x L tile of
``cum[l] - cum[s]`` and masks afterwards, it masks first: above the
diagonal the exponent passes fp32's range at a chunk of 256, and the
masked gradient is then ``0 * inf = NaN``.  Where JAX's gradient is
finite the two agree.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -2.0 ** 30


def _visible(sq: int, sk: int, causal: bool, window: int,
             device) -> torch.Tensor:
    """(Sq, Sk) bool: key k is visible to query q (top-left alignment)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """q: (B,H,S,D); k,v: (B,KV,Sk,D) with H % KV == 0. Returns (B,H,S,D),
    and with ``return_lse`` also the rows' fp32 log-sum-exp (B,H,S).

    The causal mask is aligned top-left (``k_pos <= q_pos``, both from 0).
    """
    b, h, s, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    qh = q.reshape(b, kv, g, s, d)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qh, k).float() * scale
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    ok = _visible(s, sk, causal, window, q.device)
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs, v).reshape(b, h, s, d)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def _flash_bwd_terms(q, k, v, o, lse, do, causal, window, logit_cap,
                     scale):
    """fp32 (q, dO by group, k, p, dS) of the backward formulas, with q and
    dO as (B, KV, G, Sq, D) and p, dS as (B, KV, G, Sq, Sk)."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    qh = q.float().reshape(b, kv, g, sq, d)
    doh = do.float().reshape(b, kv, g, sq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qh, kf) * scale
    fac = torch.full_like(s, scale)
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
        fac = scale * (1.0 - (s / logit_cap) ** 2)
    ok = _visible(sq, sk, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse.reshape(b, kv, g, sq, 1)), 0.0)
    dp = torch.einsum("bkgqd,bktd->bkgqt", doh, vf)
    delta = (do.float() * o.float()).sum(-1).reshape(b, kv, g, sq, 1)
    return qh, doh, kf, p, p * (dp - delta) * fac


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            logit_cap: float = 0.0,
                            scale: Optional[float] = None):
    """(dq, dk, dv) in the inputs' types, from the forward's output ``o``
    and row log-sum-exp ``lse`` (B,H,Sq) fp32.

    p = exp(s - lse) on visible entries and exactly 0 elsewhere;
    dS = p (dO V^T - rowsum(dO O)) times ds/d(q.k), which is the scale
    times 1 - (s/cap)^2 with a softcap; dQ = dS K, dK = dS^T Q and
    dV = p^T dO, the K/V gradients summed over the heads of a group.
    """
    qh, doh, kf, p, ds = _flash_bwd_terms(q, k, v, o, lse, do, causal,
                                          window, logit_cap, scale)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf).reshape(q.shape)
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qh)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_rounded_ref(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, o: torch.Tensor,
                                    lse: torch.Tensor, do: torch.Tensor, *,
                                    causal: bool = True, window: int = 0,
                                    logit_cap: float = 0.0,
                                    scale: Optional[float] = None):
    """What the bf16 tensor-core backward computes: the formulas of
    ``flash_attention_bwd_ref`` with p rounded to bf16 before dV = p^T dO
    and dS rounded to bf16 before dK = dS^T Q and dQ = dS K, the products
    summed in fp32.  Returns (dq, dk, dv) in the inputs' types."""
    qh, doh, kf, p, ds = _flash_bwd_terms(q, k, v, o, lse, do, causal,
                                          window, logit_cap, scale)
    p = p.to(torch.bfloat16).float()
    ds = ds.to(torch.bfloat16).float()
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf).reshape(q.shape)
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qh)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, doh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_dkdv_partials_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            splits: int, *, causal: bool = True,
                            window: int = 0, logit_cap: float = 0.0,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The tensor-core dK/dV kernel's partials, (2, splits, B, KV, Sk, D)
    fp32 (dK, then dV): split s sums the query heads
    [s G // splits, (s + 1) G // splits) of each group of G."""
    qh, doh, _, p, ds = _flash_bwd_terms(q, k, v, o, lse, do, causal,
                                         window, logit_cap, scale)
    g = qh.shape[2]
    out = []
    for s in range(splits):
        lo, hi = s * g // splits, (s + 1) * g // splits
        out.append(torch.stack([
            torch.einsum("bkgqt,bkgqd->bktd", ds[:, :, lo:hi],
                         qh[:, :, lo:hi]),
            torch.einsum("bkgqt,bkgqd->bktd", p[:, :, lo:hi],
                         doh[:, :, lo:hi])]))
    return torch.stack(out, dim=1)


def flash_dkdv_combine_ref(part: torch.Tensor):
    """(dK, dV) fp32 from the partials, the splits added in order."""
    acc = part[:, 0].clone()
    for s in range(1, part.shape[1]):
        acc = acc + part[:, s]
    return acc[0], acc[1]


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); scale: (d,). fp32 statistics, (1 + scale) gain."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rms_norm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6):
    """(dx in x's type, dscale fp32 (d,)).  With r = rsqrt(mean(x^2)+eps)
    and g = dy (1 + scale): dx = r g - x r^3 mean(g x), and dscale sums
    dy x r over the rows."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gf = dyf * (1.0 + scale.float())
    dx = r * gf - xf * r ** 3 * (gf * xf).mean(dim=-1, keepdim=True)
    dscale = (dyf * xf * r).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale


def ce_loss_ref(x: torch.Tensor, table: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy (T,) fp32. x: (T,d); table: (V,d);
    labels: (T,) integer.  fp32 logits, as ``repro.kernels.ref``."""
    logits = x.float() @ table.float().T
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return logz - gold


def ce_loss_logz_ref(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows' fp32 log-sum-exp (T,), which the forward kernel saves."""
    return torch.logsumexp(x.float() @ table.float().T, dim=-1)


def ce_loss_bwd_ref(x: torch.Tensor, table: torch.Tensor,
                    labels: torch.Tensor, logz: torch.Tensor,
                    g: torch.Tensor):
    """(dx in x's type, dW in the table's type) for upstream gradient ``g``
    (T,) fp32: P = g (exp(logits - logZ) - onehot(labels)), dx = P W and
    dW = P^T x."""
    logits = x.float() @ table.float().T
    p = torch.exp(logits - logz[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    p[rows, labels.long()] -= 1.0
    p = p * g.float()[:, None]
    dx = p @ table.float()
    dw = p.T @ x.float()
    return dx.to(x.dtype), dw.to(table.dtype)


def ce_loss_partials_ref(x: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, splits: int,
                         tile: int = 256) -> torch.Tensor:
    """The bf16 forward kernel's partials (T, splits, 3) fp32: per row and
    split, the max logit m, the sum l of exp(logit - m) and the gold logit
    (0 where the label lies in another split).  Split s takes the
    ``tile``-row vocab tiles [s n // splits, (s + 1) n // splits) of n."""
    logits = x.float() @ table.float().T
    v = table.shape[0]
    n = -(-v // tile)
    lbl = labels.long()[:, None]
    cols = torch.arange(v, device=x.device)[None, :]
    out = []
    for s in range(splits):
        lo, hi = s * n // splits * tile, min((s + 1) * n // splits * tile, v)
        part = logits[:, lo:hi]
        m = part.max(dim=-1).values
        l = torch.exp(part - m[:, None]).sum(dim=-1)
        hit = (cols[:, lo:hi] == lbl)
        gold = torch.where(hit, part, 0.0).sum(dim=-1)
        out.append(torch.stack([m, l, gold], dim=-1))
    return torch.stack(out, dim=1)


def ce_loss_combine_ref(part: torch.Tensor):
    """(loss, logZ) (T,) fp32 from the partials, splits in order."""
    m = part[..., 0].max(dim=-1).values
    l = (part[..., 1] * torch.exp(part[..., 0] - m[:, None])).sum(dim=-1)
    logz = torch.log(torch.clamp(l, min=1e-30)) + m
    return logz - part[..., 2].sum(dim=-1), logz


def ce_loss_bwd_chunked_ref(x: torch.Tensor, table: torch.Tensor,
                            labels: torch.Tensor, logz: torch.Tensor,
                            g: torch.Tensor, chunk: int):
    """What the bf16 backward kernels compute: the vocab in chunks of
    ``chunk`` rows; per chunk P_c = g (exp(logits - logZ) - onehot)
    rounded to bf16, dW_c = P_c^T x and dx += P_c W_c in fp32 (chunks in
    order).  Returns (dx in x's type, dW in the table's type)."""
    xf, wf = x.float(), table.float()
    lbl = labels.long()[:, None]
    dx = torch.zeros_like(xf)
    dws = []
    for c0 in range(0, table.shape[0], chunk):
        wc = wf[c0:c0 + chunk]
        cols = torch.arange(c0, c0 + wc.shape[0], device=x.device)[None, :]
        p = torch.exp(xf @ wc.T - logz[:, None]) - (cols == lbl).float()
        p = (p * g.float()[:, None]).to(torch.bfloat16).float()
        dws.append(p.T @ xf)
        dx = dx + p @ wc
    return dx.to(x.dtype), torch.cat(dws).to(table.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD scan.  x: (B,S,H,P); dt: (B,S,H) fp32; a: (H,) fp32;
# bmat, cmat: (B,S,H,N) (already broadcast from groups to heads).
# ---------------------------------------------------------------------------


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor):
    """Naive sequential recurrence in fp32 (``repro.kernels.ref``).
    Returns (y in x's type, final_state (B,H,P,N) fp32)."""
    batch, s, h, p = x.shape
    state = x.new_zeros((batch, h, p, bmat.shape[-1]), dtype=torch.float32)
    xf, dtf, bf, cf = x.float(), dt.float(), bmat.float(), cmat.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a.float())                  # (B,H)
        upd = torch.einsum("bh,bhn,bhp->bhpn", dtf[:, t], bf[:, t], xf[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _chunks(chunk: int, *tensors: torch.Tensor):
    """Each (B,S,...) tensor in fp32, zero-padded to a multiple of
    ``chunk`` and reshaped to (B, nc, chunk, ...)."""
    s = tensors[0].shape[1]
    pad = (-s) % chunk
    out = []
    for t in tensors:
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        out.append(t.reshape(t.shape[0], -1, chunk, *t.shape[2:]))
    return out


def _masked_decay(cum: torch.Tensor) -> torch.Tensor:
    """(B,nc,L,H) -> (B,nc,L,L,H): exp(cum[l] - cum[s]) for s <= l, else 0,
    with the exponent taken only below the diagonal."""
    chunk = cum.shape[2]
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=cum.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    return torch.exp(diff.masked_fill(~tri, float("-inf")))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int):
    """Chunked SSD scan (JAX ``repro.models.mamba2.ssd_chunked``, with the
    decay masked before the exponent).  Inputs are widened to fp32 first,
    as the Pallas and CUDA kernels do.  The JAX ``init_state`` has no
    counterpart: no caller passes one.  Returns (y in x's type,
    final_state (B,H,P,N) fp32)."""
    batch, s, h, p = x.shape
    n = bmat.shape[-1]
    xc, dtc, bc, cc = _chunks(chunk, x, dt, bmat, cmat)
    cum = torch.cumsum(dtc * a.float(), dim=2)                # (B,nc,L,H)
    cb = torch.einsum("bclhn,bcshn->bclsh", cc, bc)
    y = torch.einsum("bclsh,bcsh,bcshp->bclhp", cb * _masked_decay(cum),
                     dtc, xc)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,L,H)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", bc,
                          dtc * decay_to_end, xc)             # (B,nc,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    state = x.new_zeros((batch, h, p, n), dtype=torch.float32)
    starts = []
    for c in range(xc.shape[1]):
        starts.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(starts, dim=1)                         # (B,nc,H,P,N)
    y = y + torch.einsum("bclhn,bchpn,bclh->bclhp", cc, prev, torch.exp(cum))
    return y.reshape(batch, -1, h, p)[:, :s].to(x.dtype), state


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     bmat: torch.Tensor, cmat: torch.Tensor, dy: torch.Tensor,
                     dfinal: Optional[torch.Tensor] = None, *, chunk: int):
    """(dx, ddt, da, dB, dC): the gradient of ``ssd_chunked``'s (y,
    final_state) for cotangents dy and dfinal (None: zero), in fp32, by
    the formulas the backward kernel computes.  dx, dB and dC come back in
    the inputs' types, ddt and da in fp32.

    Within a chunk, with q = dt, G = C B^T, D the masked decay, dW =
    dy x^T and dh' the cotangent of the state at the chunk's end:
      dx = (G D q)^T dy + q F,           F[s] = w[s] B[s] dh'^T,
      dB = (D q dW)^T C + w q x dh',     w[s] = exp(cum[-1] - cum[s]),
      dC = (D q dW) B + exp(cum) dy h    (h: the state at chunk start),
      d cum[l] = sum_s T[l, s] - sum_l' T[l', l] + R[l] - q V
                 (+ Z + sum_s q V at the last row),
    with T = G D q dW, R[l] = exp(cum[l]) dy[l] . (C[l] h^T),
    V[s] = x[s] . F[s] and Z = exp(cum[-1]) h . dh'; d da is the reverse
    cumulative sum of d cum, ddt = sum_l G D dW + V + a d da, and
    da = sum q d da.  The cotangent carried to the previous chunk is
    exp(cum[-1]) dh' + sum_l exp(cum[l]) dy[l] C[l]^T."""
    batch, s, h, p = x.shape
    n = bmat.shape[-1]
    xc, q, bc, cc, dyc = _chunks(chunk, x, dt, bmat, cmat, dy)
    nc = xc.shape[1]
    cum = torch.cumsum(q * a.float(), dim=2)                  # (B,nc,L,H)
    ecum = torch.exp(cum)
    w = torch.exp(cum[:, :, -1:, :] - cum)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    contrib = torch.einsum("bcshn,bcsh,bcshp->bchpn", bc, q * w, xc)
    state = x.new_zeros((batch, h, p, n), dtype=torch.float32)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * chunk_decay[:, c, :, None, None] + contrib[:, c]
    hs = torch.stack(starts, dim=1)                           # (B,nc,H,P,N)
    dh = (dfinal.float() if dfinal is not None
          else x.new_zeros((batch, h, p, n), dtype=torch.float32))
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = dh
        dh = dh * chunk_decay[:, c, :, None, None] + torch.einsum(
            "blhp,blhn,blh->bhpn", dyc[:, c], cc[:, c], ecum[:, c])
    dhe = torch.stack(ends, dim=1)                            # (B,nc,H,P,N)

    dd = _masked_decay(cum)                                   # (B,nc,L,L,H)
    gd = torch.einsum("bclhn,bcshn->bclsh", cc, bc) * dd
    dw = torch.einsum("bclhp,bcshp->bclsh", dyc, xc)
    m = dd * q[:, :, None, :, :] * dw                         # D q dW
    t = gd * q[:, :, None, :, :] * dw                         # G D q dW
    colk = (gd * dw).sum(2)                                   # (B,nc,L,H)
    f = w[..., None] * torch.einsum("bcshn,bchpn->bcshp", bc, dhe)
    v = (xc * f).sum(-1)                                      # (B,nc,L,H)
    dx = torch.einsum("bclsh,bclhp->bcshp", gd * q[:, :, None, :, :], dyc) \
        + q[..., None] * f
    db = torch.einsum("bclsh,bclhn->bcshn", m, cc) \
        + (w * q)[..., None] * torch.einsum("bcshp,bchpn->bcshn", xc, dhe)
    e = ecum[..., None] * torch.einsum("bclhp,bchpn->bclhn", dyc, hs)
    dc = torch.einsum("bclsh,bcshn->bclhn", m, bc) + e
    dcum = t.sum(3) - q * colk + (cc * e).sum(-1) - q * v
    z = chunk_decay * (hs * dhe).sum((-2, -1))                # (B,nc,H)
    dcum[:, :, -1] += z + (q * v).sum(2)
    dda = dcum.flip(2).cumsum(2).flip(2)
    ddt = colk + v + a.float() * dda
    da = (q * dda).sum((0, 1, 2))

    def out(g, like):
        return g.reshape(batch, nc * chunk, *g.shape[3:])[:, :s].to(like.dtype)

    return (out(dx, x), out(ddt, dt), da.to(a.dtype), out(db, bmat),
            out(dc, cmat))
