"""Gated Delta Net (the linear-attention layers of the Qwen3.5 hybrid) in
PyTorch; counterpart of ``pegainfer_tpu/ops/gdn.py``.

The gated delta rule, per head with state S [dk, dv]:

    S_t = S_{t-1} exp(g_t) + k_t ⊗ Δ_t,   Δ_t = β_t (v_t − k_tᵀ S_{t-1} exp(g_t))
    o_t = q_tᵀ S_t

with q and k L2-normalised and q scaled by dk^-½. Prefill runs the
chunkwise form (``gdn_chunk``), decode the one-step recurrence
(``gdn_step``); the depthwise causal conv in front of them keeps the last K
inputs per request as its state. All math and all states are f32.

The JAX package leaves these to XLA (no Pallas kernel), so the port computes
them with torch ops: batched over heads, the loop over chunks sequential.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The port's prefill chunk. The in-chunk solve is O(C^2) a row, the host
# loop T / C iterations a layer: at C 64 a 1,024-token prompt is 16
# iterations a layer instead of the JAX package's 64 at C 16.
CHUNK = 64


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True) + eps)


def gdn_chunk(q, k, v, g, beta, init_state, chunk: int = CHUNK):
    """Chunkwise gated delta rule over one sequence of any length T.

    q, k: [T, H, dk]; v: [T, H, dv]; g (log decay, <= 0), beta: [T, H];
    init_state: [H, dk, dv]. Returns (out [T, H, dv] f32, final_state
    [H, dk, dv] f32).

    T is padded inside to a multiple of ``chunk`` with rows of g = 0 and
    β = 0, which leave the state as it is (their Δ is 0 and their decay 1),
    so the final state is the state after row T - 1.

    Within a chunk, ``exp(g_cum)`` (the decay from the chunk's start to each
    row) is in (0, 1] and never overflows; the matrix of row-to-row decays
    is masked to its lower triangle BEFORE the exp, whose upper entries
    would overflow to inf and give inf x 0 = NaN. At C 64 ``exp(g_cum)`` can
    underflow to 0 when the decay within a chunk passes e^-103 (f32's
    smallest denormal). That is harmless: it scales only the state carried
    into the chunk (through q and the solved k), and a term decayed by
    e^-103 is below f32's resolution of whatever it is added to, so 0 is the
    f32 answer.
    """
    T, H, dk = q.shape
    dv = v.shape[-1]
    C = chunk
    pad = (-T) % C
    qn = l2norm(q) * dk ** -0.5
    kn = l2norm(k)
    vf, gf, bf = v.float(), g.float(), beta.float()
    if pad:
        qn, kn, vf = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (qn, kn, vf))
        gf, bf = (F.pad(x, (0, 0, 0, pad)) for x in (gf, bf))
    NC = (T + pad) // C

    # head-major chunks: [H, NC, C, d] and [H, NC, C]
    qc, kc, vc = (x.permute(1, 0, 2).reshape(H, NC, C, -1) for x in (qn, kn, vf))
    gc, bc = (x.t().reshape(H, NC, C) for x in (gf, bf))

    g_cum = gc.cumsum(dim=-1)
    ones = torch.ones((C, C), dtype=torch.float32, device=q.device)
    tril = ones.tril()
    decay = torch.exp(torch.where(tril > 0, g_cum[..., :, None] - g_cum[..., None, :],
                                  0.0)) * tril
    k_beta = kc * bc[..., None]
    v_beta = vc * bc[..., None]
    # (I - A) X = I with A the strictly lower (k_beta kᵀ ∘ decay)
    A = -(k_beta @ kc.transpose(-1, -2)) * decay * ones.tril(-1)
    eye = torch.eye(C, dtype=torch.float32, device=q.device)
    Tm = torch.linalg.solve_triangular(eye - A, eye.expand(H, NC, C, C), upper=False,
                                       unitriangular=True)
    v_prime = Tm @ v_beta
    k_cd = Tm @ (k_beta * torch.exp(g_cum)[..., None])
    attn_local = (qc @ kc.transpose(-1, -2)) * decay
    q_decay = qc * torch.exp(g_cum)[..., None]
    g_last = g_cum[..., -1]  # [H, NC]
    k_tail = (kc * torch.exp(g_last[..., None] - g_cum)[..., None]).transpose(-1, -2)

    S = init_state.float()
    out = torch.empty((H, NC, C, dv), dtype=torch.float32, device=q.device)
    for n in range(NC):
        v_new = v_prime[:, n] - k_cd[:, n] @ S
        out[:, n] = q_decay[:, n] @ S + attn_local[:, n] @ v_new
        S = S * torch.exp(g_last[:, n])[:, None, None] + k_tail[:, n] @ v_new
    out = out.reshape(H, NC * C, dv)[:, :T].permute(1, 0, 2)
    return out, S


def gdn_step(q, k, v, g, beta, state):
    """One token of the recurrence, batched.

    q, k: [B, H, dk]; v: [B, H, dv]; g, beta: [B, H]; state: [B, H, dk, dv].
    Returns (out [B, H, dv] f32, state' f32).
    """
    dk = q.shape[-1]
    qn = l2norm(q) * dk ** -0.5
    kn = l2norm(k)
    S = state.float() * torch.exp(g.float())[..., None, None]
    kv_mem = (kn[..., None, :] @ S)[..., 0, :]
    delta = (v.float() - kv_mem) * beta.float()[..., None]
    S = S + kn[..., :, None] * delta[..., None, :]
    out = (qn[..., None, :] @ S)[..., 0, :]
    return out, S


def causal_conv1d(x, w):
    """Prefill conv of one whole prompt, and its state.

    x: [T, C]; w: [C, K]. Returns (y [T, C] = silu(conv) in x's dtype,
    state [K, C] f32 = the last K inputs, oldest first, zero-padded on the
    left when T < K).
    """
    T, Cdim = x.shape
    K = w.shape[-1]
    xf = x.float()
    xp = torch.cat([xf.new_zeros((K - 1, Cdim)), xf])
    wf = w.float()
    y = wf[:, 0] * xp[0:T]
    for j in range(1, K):
        y = y + wf[:, j] * xp[j:j + T]
    state = torch.cat([xf.new_zeros((K, Cdim)), xf])[T:]
    return F.silu(y).to(x.dtype), state


def causal_conv1d_cont(x, w, prev_state, valid: int):
    """Prefill-continuation conv: a chunk whose previous K inputs are in the
    slot's conv rows.

    x: [Tc, C]; w: [C, K]; prev_state: [K, C] (oldest first; zeros for a
    prompt's first chunk). Returns (y [Tc, C] silu'd in x's dtype, state
    [K, C] f32 = the last K inputs before chunk row ``valid``). Chained over
    a prompt's pieces it is ``causal_conv1d`` over the whole prompt.
    """
    Tc = x.shape[0]
    K = w.shape[-1]
    xp = torch.cat([prev_state.float(), x.float()])  # [K + Tc, C]
    wf = w.float()
    y = wf[:, 0] * xp[1:1 + Tc]
    for j in range(1, K):
        y = y + wf[:, j] * xp[j + 1:j + 1 + Tc]
    return F.silu(y).to(x.dtype), xp[valid:valid + K]


def causal_conv1d_step(x, w, state):
    """Decode conv: one new input a row.

    x: [B, C]; w: [C, K]; state: [B, K, C] (the last K inputs, oldest
    first). Returns (y [B, C] silu'd in x's dtype, state' [B, K, C] f32: the
    oldest input dropped, x appended).
    """
    window = torch.cat([state[:, 1:].float(), x.float()[:, None]], dim=1)
    y = (window * w.float().t()[None]).sum(dim=1)
    return F.silu(y).to(x.dtype), window
