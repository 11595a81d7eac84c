"""Device half of the hybrid SPECK decode (K13): PyTorch port of
sperr_tpu/ops/wave_unpack.py.

The host's control-only parse (runtime/native NativeEngine.decode3d_control)
walks the LIP/LIS control bits of a 3D SPECK stream and skips its refinement
segments, whose lengths follow from the significance history.  It gives,
per pixel, the pass at which the pixel became significant (``spass``, 255
for never) and, per pass, where the pass's refinement bits start in the
stream body and how many of them the (possibly truncated) stream holds.
``reconstruct_mags`` rebuilds the exact decoded magnitudes from these and
the body's words:

  * the members of pass p's refinement are the pixels with s < p, in
    ascending order; pass p's k-th member takes bit ref_off[p] + k of the
    body when k < ref_avail[p];
  * the received bits of a pixel, as a word (bit p from pass p), give the
    value in closed form: init(s) + (2A - M)/2 (+ the T == 1 bit), where A
    is a bit reversal of that word and M sums the weights of the passes
    whose bit was present (the reference's refinement ladder,
    SPECK_INT.cpp:360-469).

``reconstruct_mags_ref`` is the plain version, step for step the JAX
function: member masks -> per-pass member words (bit transpose), popcount
ranks, a compaction of the active (pass, word) slots up to ``evw_cap``, a
PDEP of each slot's aligned stream bits, and the transpose back.  It is built
from the plain helpers of ops/packemit.py, not from the dispatching ones,
so that it stays an independent yardstick when it runs on CUDA tensors.
``reconstruct_mags_batched`` runs K13 (kernels/unpack.cu) on CUDA tensors and
the plain version, chunk by chunk, on CPU tensors; elsewhere it raises.

Words are int32 bit patterns, as in ops/packemit.py.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from . import packemit as pe

_I32 = torch.int32


def pdep32(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Parallel bit deposit: the low bits of ``x``, in order, at the set
    positions of ``m`` (Hacker's Delight 7-5, 'expand': the move masks of
    the compress, applied in reverse with left shifts)."""
    x = x.to(_I32)
    m = m.to(_I32)
    mk = (~m) << 1
    mvs = []
    mm = m
    for i in range(5):
        mp = mk ^ (mk << 1)
        mp = mp ^ (mp << 2)
        mp = mp ^ (mp << 4)
        mp = mp ^ (mp << 8)
        mp = mp ^ (mp << 16)
        mv = mp & mm
        mm = (mm ^ mv) | pe._srl(mv, 1 << i)
        mvs.append(mv)
        mk = mk & ~mp
    for i in range(4, -1, -1):
        mv = mvs[i]
        x = (x & ~mv) | ((x << (1 << i)) & mv)
    return x & m


def reconstruct_mags_ref(
    spass: torch.Tensor,       # u8/i32 [n], 255 = never significant
    body_words: torch.Tensor,  # i32 [W] stream body words (LSB-first bits)
    ref_off: torch.Tensor,     # i32 [>= p_cap] refinement bit offsets
    ref_avail: torch.Tensor,   # i32 [>= p_cap] refinement bits present
    num_bp,                    # int or 0-dim tensor
    p_cap: int,
    evw_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K13 of one chunk -> (mags i32 [n], overflow bool ()).  The
    magnitudes equal the native full parse's when overflow is False: more
    than ``evw_cap`` active (pass, word) slots set it, and the caller then
    parses the chunk in full.  ``p_cap`` must be >= num_bp and <= 32."""
    assert p_cap <= 32, "hybrid decode covers <= 32 bitplanes"
    nb = int(num_bp)
    dev = spass.device
    n = spass.shape[0]
    npad = -(-n // 128) * 128
    s_p = spass.to(_I32)
    if npad != n:
        s_p = torch.cat([s_p, torch.full((npad - n,), 255, dtype=_I32, device=dev)])
    P = p_cap
    ref_off = ref_off.to(_I32)
    ref_avail = ref_avail.to(_I32)
    body_words = body_words.to(_I32)

    # per-pixel membership masks (bit p set iff the pixel refines at pass p:
    # s < p) -> packed per-pass member words, by bit transpose
    sig_m = s_p != 255
    memb_mask = torch.where(
        sig_m, torch.full_like(s_p, pe.ALL_ONES) << torch.clamp(s_p + 1, 0, 32),
        torch.zeros_like(s_p),
    )
    sv = pe.transpose_bits32_ref(memb_mask, take=P)            # [P, Wn]
    Wn = sv.shape[1]
    c = pe.popcount32(sv)
    rank = pe.blocked_cumsum_excl(c.reshape(-1)).reshape(P, Wn)
    rank = rank - rank[:, :1]                                  # per-row ranks
    src_off = ref_off[:P, None] + rank                         # bit offset per word
    cutoff = torch.clamp(ref_avail[:P, None] - rank, 0, 32)
    pidx = torch.arange(P, dtype=_I32, device=dev)[:, None]
    active = (c > 0) & (cutoff > 0) & (pidx < nb)

    # compact the active (pass, word) slots, ascending
    Nw = P * Wn
    take = min(evw_cap, Nw)
    sidx_r, n_act_r = pe.compact_flags_rows_ref(active.reshape(1, Nw), take)
    sidx = torch.clamp(sidx_r[0], max=Nw - 1).long()
    n_act = n_act_r[0]
    overflow = n_act > take
    wok = torch.arange(take, dtype=_I32, device=dev) < torch.clamp(n_act, max=take)

    zero = torch.zeros((), dtype=_I32, device=dev)
    off_c = torch.where(wok, src_off.reshape(-1)[sidx], zero)
    sv_c = torch.where(wok, sv.reshape(-1)[sidx], zero)
    cut_c = torch.where(wok, cutoff.reshape(-1)[sidx], zero)
    W = body_words.shape[0]
    w0 = torch.clamp(off_c >> 5, 0, W - 1).long()
    rho = off_c & 31
    lo = body_words[w0]
    hi = body_words[torch.clamp(w0 + 1, 0, W - 1)]
    aligned = pe._safe_rsh(lo, rho) | pe._safe_lsh(hi, 32 - rho)
    avail_m = pdep32(pe.ones_low32(cut_c), sv_c)
    bits_w = pdep32(aligned, sv_c) & avail_m

    # slot Nw collects the unused slots and is dropped
    planes = torch.zeros(Nw + 1, dtype=_I32, device=dev)
    tgt = torch.where(wok, sidx, torch.full_like(sidx, Nw))
    planes[tgt] = bits_w
    planes = planes[:Nw].reshape(P, Wn)
    if P < 32:
        planes = torch.cat([planes, torch.zeros((32 - P, Wn), dtype=_I32, device=dev)])
    # per-pixel refinement words: bit p = received bit at pass p
    apw = pe.untranspose_bits32(planes)

    # ---- closed-form value reconstruction (see sperr_tpu/ops/wave_unpack.py):
    # init(s) = 2T - T/2 - 1 with T = 2^(nb-1-s); the ladder sums to
    # (2A - M)/2 plus the T == 1 bit; availability is full up to pass pF,
    # partial at most at p* = pF + 1, zero after
    sig = sig_m & (s_p < nb)
    sc = torch.clamp(s_p, max=63)
    one = torch.ones((), dtype=_I32, device=dev)
    Ts = torch.where(sig, one << torch.clamp(nb - 1 - sc, 0, 30), zero)
    init = torch.where(sig, 2 * Ts - (Ts >> 1) - 1, zero)

    nb_sh = min(max(32 - nb, 0), 32)
    a_mask = pe.ones_low32(torch.tensor(min(max(nb - 1, 0), 32), dtype=_I32, device=dev))
    A = pe._safe_rsh(pe.bitrev32(apw & a_mask), nb_sh)
    last = pe._srl(apw, min(max(nb - 1, 0), 31)) & 1
    if nb < 2:
        last = torch.zeros_like(last)

    mc = c.sum(dim=1, dtype=torch.int64).to(_I32)  # members per pass
    pvec = torch.arange(P, dtype=_I32, device=dev)
    fullp = (ref_avail[:P] >= mc) & (pvec < nb)
    notfull = torch.cumsum((~fullp).to(_I32), dim=0)
    pF = int((notfull == 0).sum()) - 1                         # last fully-avail
    # full-run M: sum of 2^(nb-1-p) for p in [s+1, F], F = min(pF, nb-2)
    F = min(pF, nb - 2)
    has_full = F >= sc + 1
    M_full = torch.where(
        sig & has_full,
        (one << torch.clamp(nb - 1 - sc, 0, 30)) - (1 << min(max(nb - 1 - F, 0), 30)),
        zero,
    )
    # the single partial pass p* = pF + 1 (if it carries any bits and is not
    # the T == 1 pass): expand just its availability mask
    pstar = pF + 1
    has_star = 0 <= pstar < nb - 1
    ps = min(max(pstar, 0), P - 1)
    star_avail = int(ref_avail[ps]) if has_star else 0
    cut_star = torch.clamp(star_avail - rank[ps], 0, 32)
    am_star = pdep32(pe.ones_low32(cut_star), sv[ps])
    j = torch.arange(32, dtype=_I32, device=dev)[None, :]
    pa_star = ((am_star[:, None] >> j) & 1).reshape(-1)
    T_star = (1 << min(max(nb - 1 - pstar, 0), 30)) if has_star else 0
    M = M_full + (pa_star * T_star if (star_avail > 0 and has_star) else zero)

    val = init + ((2 * A - M) >> 1) + last
    return torch.where(sig, val, zero)[:n], overflow


def reconstruct_mags_batched_ref(spass, words, ref_off, ref_avail, num_bp, p_cap: int,
                                 evw_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K13 over B chunks, one at a time (the JAX package's lax.scan):
    spass (B, n), words (B, Wmax), ref_off and ref_avail (B, >= p_cap),
    num_bp (B,) -> (mags i32 (B, n), overflow bool (B,))."""
    outs = [
        reconstruct_mags_ref(spass[b], words[b], ref_off[b], ref_avail[b], num_bp[b], p_cap, evw_cap)
        for b in range(spass.shape[0])
    ]
    return torch.stack([m for m, _ in outs]), torch.stack([o for _, o in outs])


def reconstruct_mags_batched(spass: torch.Tensor, words: torch.Tensor, ref_off: torch.Tensor,
                             ref_avail: torch.Tensor, num_bp: torch.Tensor, p_cap: int,
                             evw_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13 on CUDA tensors (two launches: count, reconstruct), the
    plain version on CPU tensors; arguments as for
    ``reconstruct_mags_batched_ref``.  Rows whose overflow is set hold no
    defined magnitudes: the caller parses those chunks in full."""
    if pe._dispatch(spass, "reconstruct_mags"):
        return kernels.reconstruct_mags(
            spass.to(torch.uint8).contiguous(), pe._words32(words), pe._words32(ref_off),
            pe._words32(ref_avail), pe._words32(num_bp), p_cap, evw_cap,
        )
    return reconstruct_mags_batched_ref(spass, words, ref_off, ref_avail, num_bp, p_cap, evw_cap)


__all__ = ["pdep32", "reconstruct_mags_ref", "reconstruct_mags_batched_ref",
           "reconstruct_mags_batched"]
