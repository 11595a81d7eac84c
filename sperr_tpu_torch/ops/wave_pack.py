"""Device SPECK emission in the prefix-pack form (K9): PyTorch port of
``wave_emit_3d`` in sperr_tpu/ops/wave_pack.py, for every chunk shape.

Three dense [pass, position] matrices of (valid, bit) cells hold every SPECK
bit of a chunk:

  * LIP:        (decision, sign) cell pairs per pixel: a membership bit at
                every pass in (e, s] and the sign right after the decision
                that turns the pixel significant;
  * LIS:        (decision, sign) cell pairs per walk-ordered item, from the
                set walk's payload words (ops/speck_lis.py);
  * refinement: magnitude bit (num_bp-1-p) for pixels with s < p.

SPECK's within-pass order is ascending position, so the row-major order of
each matrix is stream order.  Each class's packed per-pass words are its
items' 32-pass masks bit-transposed, and the masked pack (K11) writes the
byte-aligned (class, pass) segments, class-major, that the host stitches
into a stream byte-identical to the host engines'.  The optional exposure
compaction keeps only the exposed 2x2x2 boxes of a power-of-two cube, or
the exposed pixels of any other chunk (K12).  On a CUDA tensor a 3D
emission's pixel stage is K9 (kernels/emit.cu): two launches on a cube
(``emit_cube``: the exposure's rows and scan, then the planes of the three
classes with each kept pixel's fields from its emission rank), one for the
other forms (``emit_fields``); the 2D program builds one class's planes per
launch (K9b, ``emit_planes``).  On a CPU tensor they run their plain
versions (the ``_ref`` functions: today's masks, sort and plain K10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from . import packemit as pe
from .speck_lis import lis_segments_device
from .speck_virtual import box_reduce_min, child_value_table

_NEVER = 0x7FFF
_I32 = torch.int32


class WaveEmit(NamedTuple):
    num_bp: torch.Tensor       # int32 ()
    seg: torch.Tensor          # uint8 (out_cap_bytes,) packed class-major buffer
    counts: torch.Tensor       # int32 (3 * P,), P = the num_bp_cap argument
    total_bytes: torch.Tensor  # int64 ()
    n_sig: torch.Tensor        # int32 ()
    overflow: torch.Tensor     # bool () piece, byte or exposure cap exceeded
    n_nz: torch.Tensor         # int64 () non-empty pieces (occupancy signal)
    # coefficient view from the exposure compaction (wexp_cap > 0; empty
    # otherwise): idx ascending with sentinel n, signed quantized values
    exp_idx: torch.Tensor      # int32 (<= wexp_cap,)
    exp_ll: torch.Tensor       # int32 (<= wexp_cap,)
    n_exp: torch.Tensor        # int32 () exposed-pixel count


def _pad_cols(a: torch.Tensor, cols: int, fill) -> torch.Tensor:
    have = a.shape[-1]
    if have == cols:
        return a
    pad = torch.full(a.shape[:-1] + (cols - have,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=-1)


def _emit_buffers(first_mask: torch.Tensor, P: int, per_word: int):
    """The (P, W) valid and bit word buffers that every 32-pass window of
    an emission writes its planes into (W = items // per_word)."""
    W = first_mask.shape[0] // per_word
    return tuple(torch.empty((P, W), dtype=_I32, device=first_mask.device) for _ in range(2))


def _emit_words(masks_fn, P: int):
    """Packed (valid, bit) emission words [P, M//32] from per-cell pass
    masks: ``masks_fn(base)`` returns (mask_v, mask_b) int32 [M] for the pass
    window [base, base+32).  The plain K10 writes each window's planes
    straight into the two (P, W) buffers (K9b's plain version)."""
    vw = bw = None
    for base in range(0, P, 32):
        mv, mb = masks_fn(base)
        if vw is None:
            vw, bw = _emit_buffers(mv, P, 32)
        take = min(32, P - base)
        pe.transpose_bits32_ref(mv, vw, base, take)
        pe.transpose_bits32_ref(mb, bw, base, take)
    return vw, bw


def _emit_words_pair(masks_fn, P: int):
    """Pair-class variant: ``masks_fn(base)`` returns per-item masks for the
    even (decision) and odd (sign) cell lanes (mvA, mbA, mvB, mbB)."""
    vw = bw = None
    for base in range(0, P, 32):
        mvA, mbA, mvB, mbB = masks_fn(base)
        if vw is None:
            vw, bw = _emit_buffers(mvA, P, 16)
        take = min(32, P - base)
        pe.transpose_bits32_pair_ref(mvA, mvB, vw, base, take)
        pe.transpose_bits32_pair_ref(mbA, mbB, bw, base, take)
    return vw, bw


# ---------------------------------------------------------------------------
# K9b: one class's LIP, LIS or refinement planes (the 2D program); their
# plain version is also K9's
# ---------------------------------------------------------------------------
def _nb32(num_bp: torch.Tensor) -> torch.Tensor:
    """num_bp as int32 (itself when it already is)."""
    return num_bp if num_bp.dtype == _I32 else num_bp.to(_I32)


def _lip_masks(s_p, e_p, g_i, num_bp):
    """LIP (decision, sign) cell lanes: a membership bit per pass in (e, s]
    and the sign at s."""
    zero = torch.zeros((), dtype=_I32, device=s_p.device)
    ones = torch.full((), pe.ALL_ONES, dtype=_I32, device=s_p.device)
    lip_hi = torch.minimum(s_p, num_bp - 1)

    def masks(base):
        bit_s = pe.bit_at32(s_p, base)
        mvA = pe.ones_span32(e_p + 1, lip_hi, base)
        mvB = torch.where(e_p < s_p, bit_s, zero)
        mbB = torch.where(g_i == 1, ones, zero)
        return mvA, bit_s, mvB, mbB

    return masks


def _ref_masks(s_p, m_p, num_bp):
    """Refinement: bit p of the mask is magnitude bit (num_bp-1-p), a bit
    reversal of m shifted to the ladder."""
    ref_bits = pe._safe_rsh(pe.bitrev32(m_p), (32 - num_bp).to(_I32))

    def masks(base):
        return pe.ones_span32(s_p + 1, num_bp - 1, base), pe._safe_rsh(ref_bits, base)

    return masks


def _lis_masks(pay_p, num_bp):
    """LIS (decision, sign) cell lanes from the walk's payload words (bits
    0-17: entry flag, lo, s6, sign, sign-now, has-sign, decision, ok)."""
    zero = torch.zeros((), dtype=_I32, device=pay_p.device)
    ones = torch.full((), pe.ALL_ONES, dtype=_I32, device=pay_p.device)
    is_ent = (pay_p & 1) == 1
    lo = (pay_p >> 1) & 63
    s6 = (pay_p >> 7) & 63
    sgn_i = (pay_p >> 13) & 1
    signow = (pay_p >> 14) & 1
    hs = (pay_p >> 15) & 1
    dec = (pay_p >> 16) & 1
    ok = (pay_p >> 17) & 1
    ent_hi = torch.minimum(s6, num_bp - 1)

    def masks(base):
        ent_v = torch.where(ok == 1, pe.ones_span32(lo, ent_hi, base), zero)
        bit_lo = pe.bit_at32(lo, base)
        row_v0 = torch.where(dec == 1, bit_lo, zero)
        mvA = torch.where(is_ent, ent_v, row_v0)
        mbA = torch.where(is_ent, pe.bit_at32(s6, base), torch.where(signow == 1, ones, zero))
        mvB = torch.where(is_ent, zero, torch.where(hs == 1, bit_lo, zero))
        mbB = torch.where(sgn_i == 1, ones, zero)
        return mvA, mbA, mvB, mbB

    return masks


# the padding of each class's fields past their length
_PLANE_FILLS = {"lip": (_NEVER, _NEVER, 0), "lis": (0,), "ref": (_NEVER, 0)}


def plane_masks(kind: str, fields, num_bp, items: int):
    """(masks_fn, pair) of one class: its fields padded to ``items`` and the
    function of a pass window that gives the per-item masks K10 transposes
    (the plain version's first half)."""
    fields = [_pad_cols(f.to(_I32), items, fill) for f, fill in zip(fields, _PLANE_FILLS[kind])]
    num_bp = _nb32(num_bp)
    if kind == "lip":
        return _lip_masks(*fields, num_bp), True
    if kind == "lis":
        return _lis_masks(*fields, num_bp), True
    return _ref_masks(*fields, num_bp), False


def emit_planes_ref(kind: str, fields, num_bp, P: int, items: int):
    """Plain K9b: the per-item 32-pass masks of ``plane_masks`` through the
    plain K10, window by window, into the (P, W) valid and bit planes."""
    masks_fn, pair = plane_masks(kind, fields, num_bp, items)
    return (_emit_words_pair if pair else _emit_words)(masks_fn, P)


def emit_planes(kind: str, fields, num_bp, P: int, items: int):
    """K9b: the (P, W) int32 valid and bit planes of one emission class,
    which K11 packs.  kind "lip": fields (s, e, sign), W = items // 16, the
    pixels' (decision, sign) cell pairs; "lis": (payload words,), W = items
    // 16; "ref": (s, magnitudes), W = items // 32.  Fields shorter than
    ``items`` are padded (s and e with NEVER, the rest with 0).  On a CUDA
    tensor one launch (``kernels.emit_planes``: the masks are built in
    registers and transposed by K10's shuffle stages); on a CPU tensor the
    plain version."""
    if pe._dispatch(fields[0], "emit_planes"):
        return kernels.emit_planes(kind, [pe._words32(f) if f.dtype != torch.bool else f.contiguous()
                                          for f in fields], _nb32(num_bp), P, items)
    return emit_planes_ref(kind, fields, num_bp, P, items)


# ---------------------------------------------------------------------------
# K9: the exposed-pixel compaction of a power-of-two cube and the planes
# ---------------------------------------------------------------------------
def emit_exposed_ref(pv_bm, mags, s, num_bp, N: int, wexp_cap: int, pack_mag: bool):
    """The plain exposure of K9 on a cube: exposure is a 2x2x2-box property
    (every pixel's parent is its aligned box): compact the exposed boxes at
    n/8 scale (plain K12), fetch their pixels as rows of the box-major table
    ``pv_bm``, and restore ascending-pixel (emission) order with one sort.
    Returns (exp_idx, exp_ll, n_exp, overflow, s_p, e_p, g_i, m_p) (the
    kernel keeps the four pixel fields out of device memory); the
    magnitudes come from pv_bm's high bits when ``pack_mag``, else from
    ``mags`` at the pixels' linear indices."""
    n = N ** 3
    dev = pv_bm.device
    zero = torch.zeros((), dtype=_I32, device=dev)
    never = torch.full((), _NEVER, dtype=_I32, device=dev)
    nbox = n // 8
    e_cell = box_reduce_min(torch.where(s < _NEVER, s, never).reshape(N, N, N)).reshape(-1)
    take_b = max(1, wexp_cap // 8)
    idx_box, n_box = pe.compact_flags_rows_ref((e_cell < num_bp)[None, :], take_b)
    idx_box = idx_box[0]
    n_exp = (8 * n_box[0]).to(_I32)
    exp_over = n_box[0] > take_b
    bok = idx_box < nbox
    bc = torch.clamp(idx_box, max=nbox - 1)
    bcl = bc.long()
    rows_p = pv_bm.reshape(-1, 8)[bcl]     # [take_b, 8] row gathers
    eb = torch.clamp(torch.where(bok, e_cell[bcl], never), 0, 127)
    # linear pixel index per (box, slot): box (zb, yb, xb), slot dz dy dx
    lb = N.bit_length() - 2
    bz = bc >> (2 * lb)
    rem = bc & ((1 << (2 * lb)) - 1)
    by = rem >> lb
    bx = rem & ((1 << lb) - 1)
    slot8 = torch.arange(8, dtype=_I32, device=dev)
    pz = (bz[:, None] << 1) + (slot8[None, :] >> 2)
    py = (by[:, None] << 1) + ((slot8[None, :] >> 1) & 1)
    px = (bx[:, None] << 1) + (slot8[None, :] & 1)
    lin = (pz * N + py) * N + px
    W8 = take_b * 8
    key = torch.where(bok[:, None], lin, n).reshape(W8)
    perm = torch.sort(key, stable=True).indices
    key_s = key[perm]
    pv_c = rows_p.reshape(W8)[perm]
    e_c = eb[:, None].expand(take_b, 8).reshape(W8)[perm]
    if pack_mag:
        mag_c = pv_c >> 8
    else:
        mag_c = mags[lin.reshape(W8).long()][perm]
    npad = -(-wexp_cap // 256) * 256
    okm = torch.arange(npad, dtype=_I32, device=dev) < n_exp
    pvp = _pad_cols(pv_c[:wexp_cap], npad, 0)
    s_p = torch.where(okm, pvp & 127, never)
    e_p = torch.where(okm, _pad_cols(e_c[:wexp_cap], npad, 0), never)
    g_i = torch.where(okm, (pvp >> 7) & 1, zero)
    m_p = torch.where(okm, _pad_cols(mag_c[:wexp_cap], npad, 0), zero)
    exp_idx = key_s[:wexp_cap]
    exp_ll = torch.where(okm, torch.where(((pvp >> 7) & 1) == 1, m_p, -m_p), zero)[:wexp_cap]
    return exp_idx, exp_ll, n_exp, exp_over, s_p, e_p, g_i, m_p


def stage_plane_args(pixels, pay_s, num_bp, P: int):
    """The three classes' ``emit_planes`` arguments of a 3D emission, in
    masked_pack's order (LIP, LIS, REF): the pixel items (s, e, sign,
    magnitude) padded to a multiple of 256 (a part's words must be a
    multiple of K11's piece), the walk's payload words to one of 128."""
    s_p, e_p, g_i, m_p = pixels
    items = -(-s_p.shape[0] // 256) * 256
    Tp = -(-pay_s.shape[0] // 128) * 128
    return [("lip", (s_p, e_p, g_i), num_bp, P, items), ("lis", (pay_s,), num_bp, P, Tp),
            ("ref", (s_p, m_p), num_bp, P, items)]


def emit_fields_ref(pixels, pay_s, num_bp, P: int):
    """Plain K9 planes of the 3D forms that hand their pixel fields: each
    class through ``emit_planes_ref``."""
    return [emit_planes_ref(*a) for a in stage_plane_args(pixels, pay_s, num_bp, P)]


def emit_cube_ref(pv_bm, mags, s, num_bp, N: int, wexp_cap: int, pack_mag: bool, pay_s, P: int):
    """Plain K9 on a power-of-two cube: ``emit_exposed_ref``, then each
    class's planes -> (exp_idx, exp_ll, n_exp, overflow, [(valid, bits)] of
    LIP, LIS and REF)."""
    exp_idx, exp_ll, n_exp, over, *pixels = emit_exposed_ref(pv_bm, mags, s, num_bp, N, wexp_cap,
                                                             pack_mag)
    return exp_idx, exp_ll, n_exp, over, emit_fields_ref(pixels, pay_s, num_bp, P)


def emit_cube(pv_bm, mags, s, num_bp, N: int, wexp_cap: int, pack_mag: bool, pay_s, P: int):
    """K9 on a power-of-two cube: the exposed pixels (the first
    max(1, wexp_cap // 8) exposed 2x2x2 boxes' pixels, ascending) from its
    box-major pixel table, and the LIP, LIS and REF planes, as
    ``emit_cube_ref`` computes them.  On a CUDA tensor two launches
    (``kernels.emit_cube``: the rows and their scan, then the planes, each
    pixel's fields from its emission rank); on a CPU tensor the plain
    version."""
    if pe._dispatch(pv_bm, "emit_stage"):
        return tuple(kernels.emit_cube(pv_bm, None if pack_mag else pe._words32(mags), pe._words32(s),
                                       _nb32(num_bp), N, wexp_cap, pe._words32(pay_s), P))
    return emit_cube_ref(pv_bm, mags, s, num_bp, N, wexp_cap, pack_mag, pay_s, P)


def emit_fields(pixels, pay_s, num_bp, P: int):
    """K9's planes of the 3D forms that hand their pixel fields (s, e, sign,
    magnitude): [(valid, bits)] of LIP, LIS and REF as ``emit_fields_ref``
    computes them; one launch on a CUDA tensor."""
    if pe._dispatch(pixels[0], "emit_stage"):
        return kernels.emit_fields([pe._words32(f) if f.dtype != torch.bool else f.contiguous()
                                    for f in pixels], pe._words32(pay_s), _nb32(num_bp), P)
    return emit_fields_ref(pixels, pay_s, num_bp, P)


def _compact_exposed(mags, signs, s, e, num_bp, wexp_cap: int):
    """The exposed pixels (e < num_bp), the only ones that emit LIP or
    refinement bits, compacted by K12, in ``emit_exposed_ref``'s order:
    their indices in ascending (emission) order with the sentinel n, as the
    reference's one-key sort over unique keys gives them, their signed
    values, their count, the overflow flag, and their (s, e, sign,
    magnitude) gathered from those indices and padded to 256 cells (every
    part's word count must be a multiple of masked_pack's piece_words; the
    refinement part is npad / 32 words)."""
    n = mags.shape[0]
    dev = mags.device
    idx, cnt = pe.compact_flags_rows((e < num_bp)[None, :], wexp_cap)
    key_s, n_exp = idx[0], cnt[0]
    kc = torch.clamp(key_s, max=n - 1).long()
    npad = -(-wexp_cap // 256) * 256
    okm = torch.arange(npad, dtype=_I32, device=dev) < n_exp
    zero = torch.zeros((), dtype=_I32, device=dev)
    never = torch.full((), _NEVER, dtype=_I32, device=dev)
    s_p = torch.where(okm, _pad_cols(torch.clamp(s, 0, 127)[kc], npad, 0), never)
    e_p = torch.where(okm, _pad_cols(torch.clamp(e, 0, 127)[kc], npad, 0), never)
    g_i = torch.where(okm, _pad_cols(signs.to(_I32)[kc], npad, 0), zero)
    m_p = torch.where(okm, _pad_cols(mags[kc], npad, 0), zero)
    exp_ll = torch.where(g_i == 1, m_p, -m_p)[:wexp_cap]
    return key_s, exp_ll, n_exp, n_exp > wexp_cap, s_p, e_p, g_i, m_p


def _every_pixel(mags, signs, s, e):
    """No compaction, in ``emit_exposed_ref``'s order: an empty coefficient
    view, no overflow, and every pixel's (s, e, sign, magnitude)."""
    dev = mags.device
    empty = torch.zeros(0, dtype=_I32, device=dev)
    return (empty, empty, torch.zeros((), dtype=_I32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev), s, e, signs, mags)


def _pixel_planes(s_p, e_p, g_i, m_p, num_bp, P: int):
    """The LIP and refinement planes (K9b) of a 2D field's pixel items,
    padded to a multiple of 256 (a part's words must be a multiple of K11's
    piece)."""
    items = -(-s_p.shape[0] // 256) * 256
    return [emit_planes("lip", (s_p, e_p, g_i), num_bp, P, items),
            emit_planes("ref", (s_p, m_p), num_bp, P, items)]


def wave_emit_3d(mags, signs, s, e, node_s, num_bp, li, num_bp_cap: int,
                 node_cap: int, evb_cap: int, out_cap_bytes: int,
                 wexp_cap: int = 0) -> WaveEmit:
    """Full SPECK bit emission for one chunk.

    Inputs are the int32 magnitudes, bool signs, the per-pixel schedule
    (s, e from ``pixel_schedule_virtual``, ``pixel_schedule`` or
    ``pixel_schedule_pyramid``), the per-node significance passes node_s,
    num_bp (an int32 0-d tensor) and the walk index ``li``
    (``VirtualLisIndex`` or ``LisIndex``).  ``wexp_cap`` > 0 (and < n)
    compacts the exposed pixels first (K9 for a power-of-two cube, K12
    otherwise), so the LIP and refinement matrices shrink to the exposed
    neighbourhood; exposure overflow sets the overflow flag (tier retry).
    Between the walk and K11 a power-of-two cube on a CUDA tensor runs hand
    kernels only: K9's two launches (``emit_cube``); the other forms make
    one (``emit_fields``)."""
    n = mags.shape[0]
    P = num_bp_cap
    mags = mags.to(_I32)
    uniform = getattr(li, "uniform_children", False)
    compact = bool(wexp_cap) and wexp_cap < n

    # virtual forest: one box-major pixel table, clip(s) | sign << 7 | mag << 8
    # (mags fit below bit 31 for bitplane caps <= 23; deeper caps read them
    # from the linear array), serves the walk's child values and the
    # exposure compaction
    pack_mag = P <= 23
    vtab = None
    if uniform:
        # one launch on the card (walk_vtab); its pixel section is pv_bm
        vtab = child_value_table(li, s, signs, node_s, mags if pack_mag else None)

    # --- LIS items: the set walk, as walk-ordered payload words ----------
    pay_s, n_sig = lis_segments_device(
        node_s, s, signs, num_bp, li, num_bp_cap, node_cap, return_events="items", vtab=vtab,
    )
    if compact and uniform:
        exp_idx, exp_ll, n_exp, exp_over, parts = emit_cube(vtab[:n], mags, s, num_bp, li.dims[0],
                                                            wexp_cap, pack_mag, pay_s, P)
    else:
        exposed = (_compact_exposed(mags, signs, s, e, num_bp, wexp_cap) if compact
                   else _every_pixel(mags, signs, s, e))
        exp_idx, exp_ll, n_exp, exp_over, *pixels = exposed
        parts = emit_fields(pixels, pay_s, num_bp, P)
    res = pe.masked_pack(parts, evb_cap, out_cap_bytes)
    return WaveEmit(
        num_bp.to(_I32), pe.words_to_bytes(res.out_words), res.counts,
        res.total_bytes, n_sig, res.overflow | exp_over, res.n_nz,
        exp_idx, exp_ll, n_exp,
    )


def wave_emit_2d_pixels(mags, signs, s, e, num_bp, px_bp_cap: int, evb_cap: int,
                        out_cap_bytes: int, wexp_cap: int = 0):
    """LIP and refinement emission of one 2D field, prefix-pack form (K14's
    pixel half).  A pixel's bits do not depend on the set geometry (a
    membership bit per pass in (e, s], its sign at s, magnitude bits below
    s), so this is the LIP and refinement part of ``wave_emit_3d``: the
    planes of K9b, packed by K11.  ``wexp_cap`` > 0 (and < n) compacts the
    exposed pixels first (K12); exposure overflow sets the overflow flag.

    Returns (seg uint8 [out_cap_bytes], counts int32 [2 * px_bp_cap], the
    LIP rows then the refinement rows, total_bytes, overflow)."""
    mags = mags.to(_I32)
    if wexp_cap and wexp_cap < mags.shape[0]:
        exposed = _compact_exposed(mags, signs, s, e, num_bp, wexp_cap)
        pixels, exp_over = exposed[4:], exposed[3]
    else:  # every pixel, no torch op besides the kernels
        pixels, exp_over = (s, e, signs, mags), None
    res = pe.masked_pack(_pixel_planes(*pixels, num_bp, px_bp_cap), evb_cap, out_cap_bytes)
    over = res.overflow if exp_over is None else res.overflow | exp_over
    return pe.words_to_bytes(res.out_words), res.counts, res.total_bytes, over


def wave_emit_2d_lis(pay_s, n_sig, num_bp, num_bp_cap: int, ev_cap: int, cap_total: int):
    """The LIS bits of one 2D field from its walk's payload words (K14's set
    half): the planes of K9b, packed by K11, as ``wave_emit_3d`` packs the
    3D walk's planes.  Returns (buf uint8 [cap_total], counts int32 [num_bp_cap],
    total_bytes int64, n_sig int32), the event form's layout
    (``speck_lis._event_tail``): the byte-aligned per-pass segments, zero
    past the total.  n_sig is raised past any node cap where the event form
    raises it: more bits than ``ev_cap``, or more bytes than ``cap_total``.
    K11's piece cap never binds (every piece may be non-empty) and its
    buffer holds cap_total bytes, so a stream that fits is never cut."""
    Tp = -(-pay_s.shape[0] // 128) * 128
    planes = emit_planes("lis", (pay_s,), num_bp, num_bp_cap, Tp)
    res = pe.masked_pack([planes], num_bp_cap * Tp // 16 // 8, -(-cap_total // 4) * 4)
    over = (res.counts.sum() > ev_cap) | (res.total_bytes > cap_total)
    n_sig = torch.where(over, torch.full_like(n_sig, 2**31 - 1), n_sig)
    return pe.words_to_bytes(res.out_words)[:cap_total], res.counts, res.total_bytes, n_sig


__all__ = ["wave_emit_3d", "wave_emit_2d_pixels", "wave_emit_2d_lis", "WaveEmit", "emit_cube",
           "emit_fields", "emit_planes"]
