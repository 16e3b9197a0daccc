"""Plain PyTorch versions of the port's kernels: the semantics contract.

Each CUDA kernel in ``csrc/`` is held bit for bit against the function of
the same name here: by ``chip_smoke.py`` on the card, and by the tests on
the CPU against ``repro.kernels.ref``.  ``repro_torch.kernels.ops`` calls
these for tensors that lie on the CPU, and only for those.

Lanes are int32 tensors holding uint32 bit patterns; the math runs in int64
masked to 32 bits (``repro_torch.core.hashing``).  The paged-attention
functions and ``fused_norm_matmul_ref`` keep ``repro.kernels.ref``'s
layouts and compute in float32.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import slots
from repro_torch.core.hashing import hash64_32, i32, slot_hash, u32


def ludo_lookup_ref(key_lo, key_hi, words_a, words_b, seeds, *, ma, mb, nb,
                    seed_a, seed_b, seed_ba, seed_bb):
    """Batched CN locator math: keys -> (bucket, slot), both int32."""
    ia = hash64_32(key_lo, key_hi, seed_a) % ma
    ib = hash64_32(key_lo, key_hi, seed_b) % mb
    bit_a = (u32(words_a[ia >> 5]) >> (ia & 31)) & 1
    bit_b = (u32(words_b[ib >> 5]) >> (ib & 31)) & 1
    b0 = hash64_32(key_lo, key_hi, seed_ba) % nb
    b1 = hash64_32(key_lo, key_hi, seed_bb) % nb
    bucket = torch.where((bit_a ^ bit_b).bool(), b1, b0)
    slot = slot_hash(key_lo, key_hi, seeds[bucket].to(torch.int64))
    return bucket.to(torch.int32), slot.to(torch.int32)


def slot_unpack_ref(s_lo, s_hi):
    """Packed 64-bit DMPH slots -> (cache, fp, length, addr), all int32;
    ``addr`` is the uint32 ``addr_lo`` as an int32 bit pattern."""
    f = slots.unpack(s_lo, s_hi)
    return (f["cache"].to(torch.int32), f["fp"].to(torch.int32),
            f["len"].to(torch.int32), i32(f["addr_lo"]))


def paged_attention_ref(q, k_pool, v_pool, page_map, seq_len):
    """Flash-decode oracle over a paged KV pool (one sequence).

    q:        (n_kv, group, d)     GQA query heads grouped per KV head
    k_pool:   (P, ps, n_kv, d)     physical page pool
    v_pool:   (P, ps, n_kv, d)
    page_map: (L,) int32           logical page -> physical page
    seq_len:  int                  valid tokens
    Returns the float32 flash partials (o, m, l): ``(n_kv, g, d)``,
    ``(n_kv, g)``, ``(n_kv, g)``.  On the card the products run in full
    float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False.
    """
    L = page_map.shape[0]
    ps = k_pool.shape[1]
    n_kv, g, d = q.shape
    pm = page_map.long()
    k = k_pool[pm].reshape(L * ps, n_kv, d).transpose(0, 1)  # (n_kv, S, d)
    v = v_pool[pm].reshape(L * ps, n_kv, d).transpose(0, 1)
    scores = torch.einsum("hgd,hsd->hgs", q.float(), k.float()) \
        / math.sqrt(float(d))
    pos = torch.arange(L * ps, device=q.device)
    scores = torch.where(pos[None, None, :] < int(seq_len), scores,
                         float("-inf"))
    m = scores.max(dim=-1).values
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("hgs,hsd->hgd", p, v.float()) / l[..., None]
    return o, m, l


def combine_flash_partials(o_parts, m_parts, l_parts):
    """Combine flash partials from independent KV ranges: re-weight each
    normalised ``o`` by ``exp(m - m_max) * l`` and renormalise by the sum of
    the weights."""
    m_max = torch.stack(list(m_parts)).max(dim=0).values  # (n_kv, g)
    num, den = 0.0, 0.0
    for o, m, l in zip(o_parts, m_parts, l_parts):
        w = torch.exp(m - m_max) * l
        num = num + o * w[..., None]
        den = den + w
    return num / den[..., None]


# the finite score of a masked position in the paged kernels
NEG_SENTINEL = -1e30


def split_step_ranges(n_pages: int, split_pages: int, fetches: int) -> list:
    """The step ranges ``[s0, s1)`` of the paged kernels' runs of
    ``split_pages`` logical pages, ``fetches`` steps a page (1 for Ludo, 2
    for cuckoo: both candidates of a page in one run)."""
    return [(p0 * fetches, min(n_pages, p0 + split_pages) * fetches)
            for p0 in range(0, n_pages, split_pages)]


def paged_split_partials(q, k_pool, v_pool, page_ids, seq_len,
                         split_pages: int, select=None):
    """The split pass of ``csrc/paged_attention.cu``, step by step as the
    kernel takes it: for each run of ``split_pages`` logical pages, the
    online softmax over its steps with masked positions at the finite
    ``NEG_SENTINEL`` -> float32 ``acc (S, n_kv, g, d)``, ``m`` and ``l``
    ``(S, n_kv, g)`` for S runs, ``acc`` not yet divided by ``l``.

    ``page_ids`` is ``page_map (L,)``, or ``page_map2 (L, 2)`` with
    ``select (L,)`` for the cuckoo baseline, whose unselected candidate is
    loaded and scores as masked.  A page id outside the pool reads zero
    tiles and scores as masked."""
    n_kv, g, d = q.shape
    n_pool, ps = k_pool.shape[0], k_pool.shape[1]
    fetches = 1 if select is None else 2
    ids = page_ids.reshape(-1).tolist()
    sel = None if select is None else select.tolist()
    qf = q.float()
    zeros = torch.zeros((ps, n_kv, d), device=q.device)
    accs, ms, ls = [], [], []
    for s0, s1 in split_step_ranges(len(ids) // fetches, split_pages,
                                    fetches):
        m = torch.full((n_kv, g), NEG_SENTINEL, device=q.device)
        l = torch.zeros((n_kv, g), device=q.device)
        acc = torch.zeros((n_kv, g, d), device=q.device)
        for step in range(s0, s1):
            page, pos = ids[step], step // fetches
            in_pool = 0 <= page < n_pool
            valid = in_pool and (sel is None or sel[pos] == step % 2)
            k = k_pool[page].float() if in_pool else zeros
            v = v_pool[page].float() if in_pool else zeros
            s = torch.einsum("hgd,thd->hgt", qf, k) / math.sqrt(float(d))
            live = valid & (pos * ps + torch.arange(ps, device=q.device)
                            < int(seq_len))
            s = torch.where(live, s, NEG_SENTINEL)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("hgt,thd->hgd", p, v)
            m = m_new
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def combine_split_partials(acc, m, l):
    """The combine pass of ``csrc/paged_attention.cu`` over the runs'
    partials (leading axis): ``m = max m_i``, ``l = sum l_i exp(m_i - m)``,
    ``o = sum acc_i exp(m_i - m) / max(l, 1e-30)`` -> float32 (o, m, l).
    ``combine_flash_partials``' formula over un-normalised ``acc``, also
    returning ``m`` and ``l``; a run past ``seq_len`` (``m_i = -1e30``)
    weighs 0."""
    m_max = m.max(dim=0).values
    w = torch.exp(m - m_max)
    l_tot = (l * w).sum(dim=0)
    o = (acc * w[..., None]).sum(dim=0) / l_tot.clamp_min(1e-30)[..., None]
    return o, m_max, l_tot


def fused_norm_matmul_ref(x, gamma, w, eps: float = 1e-6):
    """``RMSNorm(x) * gamma @ w``, the dense-arch QKV/MLP entry: x (S, d),
    gamma (d,), w (d, F).  The norm and the product run in float32 and the
    result has the dtype of ``x``; on the card the product is full float32
    only while ``torch.backends.cuda.matmul.allow_tf32`` is False (float64,
    which no kernel takes, stays float64: gradcheck's inputs)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    nrm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((nrm * gamma.to(ct)) @ w.to(ct)).to(x.dtype)


def fused_norm_matmul_bwd_ref(x, gamma, w, dy, eps: float = 1e-6):
    """The gradients of :func:`fused_norm_matmul_ref` given ``dy`` (S, F)
    -> ``(dx, dgamma, dw)`` in the dtypes of ``x``, ``gamma`` and ``w``,
    computed in float32 (float64 stays float64).  With ``r = rsqrt(mean(x^2)
    + eps)``, ``n = x * r`` and ``dN = dy @ w^T``: ``dgamma = sum_s dN * n``,
    ``g = dN * gamma``, ``dx = r * (g - n * mean(g * n))`` and ``dw = (n *
    gamma)^T @ dy``."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, gf, wf, dyf = x.to(ct), gamma.to(ct), w.to(ct), dy.to(ct)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    n = xf * r
    dn = dyf @ wf.T
    dgamma = (dn * n).sum(dim=0)
    g = dn * gf
    dx = r * (g - n * (g * n).mean(dim=-1, keepdim=True))
    dw = (n * gf).T @ dyf
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dw.to(w.dtype)


def fused_norm_matmul_split_partials(x, gamma, w, krange: int):
    """The stream regime's split pass of ``csrc/fused_norm_matmul.cu``, with
    the norm factored out of the dot: for each K-split of ``krange`` rows of
    d (the last one shorter), ``sum_k (x * gamma)[s, k] * w[k, f]`` and
    ``sum_k x[s, k]^2`` over its rows -> float32 ``part (splits, S, F)`` and
    ``ss (splits, S)``."""
    xf, gf, wf = x.float(), gamma.float(), w.float()
    parts, sss = [], []
    for k0 in range(0, x.shape[1], krange):
        xs = xf[:, k0:k0 + krange]
        parts.append((xs * gf[k0:k0 + krange]) @ wf[k0:k0 + krange])
        sss.append((xs * xs).sum(dim=1))
    return torch.stack(parts), torch.stack(sss)


def combine_fused_norm_matmul_partials(part, ss, d: int, eps: float = 1e-6,
                                       dtype=torch.float32):
    """The combine pass over the splits' partials (leading axis), summed in
    split order: ``out = sum part_i * rsqrt(sum ss_i / d + eps)``, rounded
    once to ``dtype``."""
    tot, sst = part[0], ss[0]
    for p, s in zip(part[1:], ss[1:]):
        tot, sst = tot + p, sst + s
    return (tot * torch.rsqrt(sst / d + eps)[:, None]).to(dtype)


def fused_norm_matmul_rows(x, gamma, a_dtype, pad: int = 64,
                           eps: float = 1e-6):
    """The prefill regimes' rows pass: ``x * gamma`` rounded once to
    ``a_dtype`` (bf16 for the tensor cores, float32 for the FMA tile) with
    the rows padded by zeros to a multiple of ``pad`` columns, and the
    float32 inverse RMS of each row; the kernel then computes
    ``inv_rms[:, None] * (xg @ w)`` in float32 (``w`` padded alike)."""
    xf = x.float()
    S, d = x.shape
    dp = -(-d // pad) * pad
    xg = torch.zeros((S, dp), dtype=a_dtype, device=x.device)
    xg[:, :d] = (xf * gamma.float()).to(a_dtype)
    return xg, torch.rsqrt((xf * xf).sum(dim=1) / d + eps)
