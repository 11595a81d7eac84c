"""Table-free SPECK partition forest for power-of-two cube chunks.

PyTorch port of sperr_tpu/ops/speck_virtual.py, plus ``msbp1_device`` of
sperr_tpu/ops/speck_jax.py.  For power-of-two cube dims the SPECK partition
forest is regular, so every per-node quantity the set walk needs (parent,
level, path digits, child resolution) is arithmetic on the node id:

  * the roots are the wavelet subbands: ``big`` (the coarsest LLL cube) plus
    7 octant complements per split level, all power-of-two cubes;
  * below a root every partition is a full octant split, so a node is
    (root, depth, morton) with 3-bit morton digits x fastest;
  * the BFS numbering of ``codec.speck_wave.build_tree`` is depth-major,
    root-major, morton-minor, so ids convert to and from (root, depth,
    morton) with tiny static tables.

``VirtualLisIndex`` keeps its constants as numpy arrays and as tensors on
the device it was made for (cached per dims and device);
``pixel_schedule_virtual`` (K6) gives each pixel's significance pass s, each
pixel's exposure pass e and each node's maximum nm from one morton max
pyramid, and ``schedule_virtual`` (K5 and K6 fused) gives num_bp with them;
``dense_anchor_ranks`` (K7) gives the set walk's chain anchors and their
string ranks, and ``child_value_table`` the walk's box-major table of child
values.  Integer results equal the JAX package's bit for bit.  On a CUDA
tensor the schedule runs the hand kernels of kernels/schedule.cu
(``sched_boxmax``, ``sched_virtual``), K7 and the table those of
kernels/walk.cu (``anchor_ranks``, ``walk_vtab``); on a CPU tensor their
plain versions, and everywhere else in this module, torch ops run on the
tensors' device.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils.dims import can_use_dyadic
from .packemit import _dispatch, _words32

_NEVER = 0x7FFF
_I32 = torch.int32


def _is_pow2_cube(dims) -> bool:
    nx, ny, nz = (int(d) for d in dims)
    return (
        nx == ny == nz
        and nx >= 2
        and (nx & (nx - 1)) == 0
        and can_use_dyadic((nx, ny, nz)) is not None
    )


def msbp1_device(mags: torch.Tensor) -> torch.Tensor:
    """K5: msb position + 1 per magnitude (0 for zero); int32 in and out."""
    m = mags.to(_I32)
    out = torch.zeros_like(m)
    for shift in (16, 8, 4, 2, 1):
        big = m >= (1 << shift)
        out = out + torch.where(big, shift, 0).to(_I32)
        m = torch.where(big, m >> shift, m)
    return torch.where(mags > 0, out + 1, torch.zeros_like(out))


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)


def _bcast(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each element k times, flat: [C] -> [C * k]."""
    return x[:, None].expand(x.shape[0], k).reshape(-1)


class VirtualLisIndex:
    """Walk-interface index for power-of-two cube dims, no per-node tables.

    Device constants are O(#roots) (plus the per-depth level vectors that
    ``dense_anchor_ranks`` reads, O(nodes)).  Ids are the partition tree's
    BFS numbering."""

    # every node's children are uniformly pixels or uniformly nodes (full
    # octant splits): enables the parent-form born compaction in the walk
    uniform_children = True

    def __init__(self, dims, device):
        nx, ny, nz = (int(d) for d in dims)
        if not _is_pow2_cube((nx, ny, nz)):
            raise ValueError("VirtualLisIndex requires power-of-two cube dims")
        dev = torch.device(device)
        self.device = dev
        N = nx
        K = N.bit_length() - 1
        xf = can_use_dyadic((N, N, N))
        self.dims = (N, N, N)
        self.K = K
        self.n = N * N * N

        # roots in morton-assignment order: levels finest-first, `big`
        # first within its level (speck_wave.build_tree)
        orgs: List[Tuple[int, int, int]] = [(0, 0, 0)]
        slogs: List[int] = [K - xf]
        levels: List[int] = [3 * xf]
        for i in range(xf - 1, -1, -1):
            h = N >> (i + 1)
            for k in range(1, 8):
                orgs.append(((k & 1) * h, ((k >> 1) & 1) * h, (k >> 2) * h))
                slogs.append(K - (i + 1))
                levels.append(3 * (i + 1))
        R = len(orgs)
        self.nroots = R
        slog = np.asarray(slogs, dtype=np.int32)
        org = np.asarray(orgs, dtype=np.int32)  # (x, y, z)
        rlev = np.asarray(levels, dtype=np.int32)
        assert (np.diff(slog) >= 0).all()

        self.depth_max = max(int(slog.max()) - 1, 0)
        D = self.depth_max
        # id numbering: depth-major, then root-major, then morton.
        # depth_base[d] = first id at depth d; r0[d] = first contributing root
        r0 = np.empty(D + 2, dtype=np.int32)
        counts = np.empty(D + 2, dtype=np.int64)
        for d in range(D + 2):
            contrib = slog >= d + 1
            r0[d] = int(np.argmax(contrib)) if contrib.any() else R
            counts[d] = int(contrib.sum()) << (3 * d)
        depth_base = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.nn = int(depth_base[D + 1])
        assert self.nn < 2**31
        # nodes whose children are nodes (side >= 4): the exact bound of the
        # parent-form born compaction in the set walk
        self.nn_inner = int(
            sum(int((slog >= d + 2).sum()) << (3 * d) for d in range(D + 1))
        )
        self.nlev = 3 * K + 1

        # root pre-assignment: per-level insertion ranks in root order
        O0_head = np.zeros(R, dtype=np.int32)
        off0 = np.zeros(self.nlev, dtype=np.int32)
        for r in range(R):
            L = int(rlev[r])
            O0_head[r] = off0[L]
            off0[L] += 1

        self.max_ch = 8
        self.shallow = True
        assert D + 1 <= 12, "virtual path packing supports depth <= 12"

        self.h_slog = slog
        self.h_org = org
        self.h_rlev = rlev
        self.h_depth_base = depth_base
        self.h_r0 = r0
        self.h_off0 = off0
        self.h_O0_head = O0_head
        self.r_slog = _i32(slog, dev)
        self.r_org = _i32(org, dev)
        self.r_level = _i32(rlev, dev)
        self.depth_base = _i32(depth_base, dev)
        self.r0 = _i32(r0, dev)
        self.root_ids = torch.arange(R, dtype=_I32, device=dev)
        self.root_levels = _i32(rlev, dev)
        self.root_from = torch.zeros(R, dtype=_I32, device=dev)
        self.off0 = _i32(off0, dev)
        self.O0_head = _i32(O0_head, dev)

        # 8-aligned combined child-value table: [0, n) = pixel section in
        # 2x2x2-box-major order (slots dz dy dx, x fastest), then one node_s
        # section per depth, each 8-aligned so every child octet is one row
        A8 = np.zeros(D + 2, dtype=np.int64)
        off = self.n
        for d in range(D + 1):
            cnt = int(depth_base[d + 1] - depth_base[d])
            A8[d] = off // 8
            off += cnt + ((-cnt) % 8)
        self.nt = int(off)
        self.h_A8 = A8
        self.A8 = _i32(A8, dev)
        # slog[r] as a run-start sum over the <= K distinct slog runs
        starts = []
        for v in range(int(slog[0]) + 1, int(slog[-1]) + 1):
            starts.append(int(np.argmax(slog >= v)))
        self.h_slog_starts = (int(slog[0]), tuple(starts))
        self._anchor_plan = None
        self._walk_forest = None
        self._rank_plan = None

        # nm in BFS-id order as slices of the morton pyramid's grids: rows
        # (grid g, lo, hi, output offset), one per depth and run of roots of
        # one side.  A run of 8 is big + the 7 finest octants; a run of 7
        # drops the (0, 0, 0) corner (it belongs to deeper roots); a single
        # big root is octant 0 alone.
        segs = []
        out = 0
        for d in range(D + 1):
            r = int(r0[d])
            while r < R:
                r_end = r
                while r_end < R and slog[r_end] == slog[r]:
                    r_end += 1
                blk = 1 << (3 * d)
                run = r_end - r
                lo = blk if run == 7 else 0
                hi = 8 * blk if run in (7, 8) else blk
                segs.append((K - (int(slog[r]) - d), lo, hi, out))
                out += hi - lo
                r = r_end
        assert out == self.nn
        self.h_nm_segs = np.asarray(segs, dtype=np.int32).reshape(-1, 4)
        self.nm_segs = _i32(self.h_nm_segs, dev)

    # -- id <-> (root, depth, morton) ---------------------------------------
    def _decode_sums(self, ids):
        """(d, depth_base[d], r0[d]) by static compare-sums over the tiny
        depth table."""
        db = self.h_depth_base
        r0 = self.h_r0
        d = torch.zeros_like(ids)
        dbase = torch.zeros_like(ids)
        rbase = torch.full_like(ids, int(r0[0]))
        for k in range(1, self.depth_max + 2):
            ge = ids >= int(db[k])
            d = d + ge.to(ids.dtype)
            dbase = dbase + torch.where(ge, int(db[k] - db[k - 1]), 0).to(ids.dtype)
            rbase = rbase + torch.where(ge, int(r0[k] - r0[k - 1]), 0).to(ids.dtype)
        return d, dbase, rbase

    def decode(self, ids):
        """ids (any shape, values in [0, nn)) -> (r, d, m), elementwise."""
        d, dbase, rbase = self._decode_sums(ids)
        rem = ids - dbase
        r = rbase + (rem >> (3 * d))
        m = rem & ((torch.ones_like(d) << (3 * d)) - 1)
        return r, d, m

    def slog_of_roots(self, r):
        """slog[r] elementwise via the static run-start sum."""
        base, starts = self.h_slog_starts
        v = torch.full_like(r, base)
        for s0 in starts:
            v = v + (r >= s0).to(r.dtype)
        return v

    def nid(self, r, d, m):
        """(r, d, m) -> id; d is clamped into range (callers mask misuse)."""
        dc = torch.clamp(d, 0, self.depth_max).long()
        return self.depth_base[dc] + ((r - self.r0[dc]) << (3 * dc).to(r.dtype)) + m

    def _unmorton(self, m):
        """3-bit-digit deinterleave: morton -> (bx, by, bz) box coords."""
        bx = torch.zeros_like(m)
        by = torch.zeros_like(m)
        bz = torch.zeros_like(m)
        for t in range(self.depth_max + 1):
            bx = bx | (((m >> (3 * t)) & 1) << t)
            by = by | (((m >> (3 * t + 1)) & 1) << t)
            bz = bz | (((m >> (3 * t + 2)) & 1) << t)
        return bx, by, bz

    def _path_words(self, d, m):
        """Packed path-digit words (depth j digit at word j//6, shift
        5*(5 - j%6)), matching codec/speck_sorted.py's layout."""
        w0 = torch.zeros_like(m)
        w1 = torch.zeros_like(m)
        for j in range(self.depth_max + 1):
            sh = torch.clamp(3 * (d - 1 - j), min=0)
            dig = torch.where(j < d, ((m >> sh) & 7) + 1, 0).to(m.dtype)
            if j < 6:
                w0 = w0 | (dig << (5 * (5 - j)))
            else:
                w1 = w1 | (dig << (5 * (11 - j)))
        return [w0, w1]

    # -- walk interface ------------------------------------------------------
    def children(self, q, svalid, slot):
        """Resolve all child slots of compacted parents q: (cnt [C], rvalid,
        ispx, isnd [C, 8], vidx [C, 8]) where vidx is the combined value
        index (pixel linear id, or n + node id)."""
        N = self.dims[0]
        r, d, m = self.decode(q)
        side_log = self.r_slog[r.long()] - d
        cnt = torch.where(svalid, 8, 0).to(q.dtype)
        rvalid = slot[None, :] < cnt[:, None]
        px_parent = side_log == 1
        ispx = px_parent[:, None] & rvalid
        isnd = (~px_parent)[:, None] & rvalid
        mc = (m[:, None] << 3) + slot[None, :]
        cid = self.nid(r[:, None], (d + 1)[:, None], mc)
        bx, by, bz = self._unmorton(m)
        rl = r.long()
        ox = self.r_org[rl, 0] + (bx << 1)
        oy = self.r_org[rl, 1] + (by << 1)
        oz = self.r_org[rl, 2] + (bz << 1)
        px = ox[:, None] + (slot[None, :] & 1)
        py = oy[:, None] + ((slot[None, :] >> 1) & 1)
        pz = oz[:, None] + (slot[None, :] >> 2)
        lin = (pz * N + py) * N + px
        vidx = torch.where(ispx, lin, self.n + cid)
        return cnt, rvalid, ispx, isnd, vidx

    def org_of_roots(self, r):
        """Root origin (ox, oy, oz) elementwise: split root r of split level
        i is octant k with h = N >> (i+1)."""
        N = self.dims[0]
        slog = self.slog_of_roots(r)
        xf = self.K - int(self.h_slog[0])
        i = self.K - slog - 1
        g0 = 1 + 7 * (xf - 1 - i)
        k = r - g0 + 1
        h = N >> torch.clamp(self.K - slog, 0, 30)
        zero = torch.zeros_like(r)
        ox = torch.where(r > 0, (k & 1) * h, zero)
        oy = torch.where(r > 0, ((k >> 1) & 1) * h, zero)
        oz = torch.where(r > 0, (k >> 2) * h, zero)
        return ox, oy, oz

    def parents_of(self, ids):
        """Parent node id per node (-1 at roots), arithmetically."""
        r, d, m = self.decode(ids)
        pid = self.nid(r, torch.clamp(d - 1, min=0), m >> 3)
        return torch.where(d > 0, pid, torch.full_like(pid, -1))

    def levels_of(self, ids):
        r, d, _ = self.decode(ids)
        return 3 * (self.K - self.slog_of_roots(r) + d)

    # -- streamlined walk support --------------------------------------------
    def box_major_pixels(self, pixel_vals):
        """Linear pixel array -> 2x2x2-box-major order (boxes by (zb, yb,
        xb), slots dz dy dx)."""
        Nh = self.dims[0] // 2
        return (
            pixel_vals.reshape(Nh, 2, Nh, 2, Nh, 2)
            .permute(0, 2, 4, 1, 3, 5)
            .reshape(-1)
        )

    def vtab_from(self, pix_bm, node_s):
        """Combined 8-aligned child value table from a box-major pixel
        section ++ per-depth node_s sections (padded with NEVER)."""
        parts = [pix_bm]
        db = self.h_depth_base
        for d in range(self.depth_max + 1):
            lo, hi = int(db[d]), int(db[d + 1])
            parts.append(node_s[lo:hi])
            pad = (-(hi - lo)) % 8
            if pad:
                parts.append(torch.full((pad,), _NEVER, dtype=node_s.dtype, device=node_s.device))
        return torch.cat(parts)

    def children_rows(self, q, svalid, slot, vtab):
        """Child resolution with the values fetched as row gathers from the
        8-aligned table: (cnt, rvalid, ispx, isnd, vidx, v) where v[c, k] is
        child k's table value."""
        N = self.dims[0]
        Nh = N // 2
        D = self.depth_max
        r, d, m = self.decode(q)
        side_log = self.slog_of_roots(r) - d
        cnt = torch.where(svalid, 8, 0).to(q.dtype)
        rvalid = slot[None, :] < cnt[:, None]
        px_parent = side_log == 1
        ispx = px_parent[:, None] & rvalid
        isnd = (~px_parent)[:, None] & rvalid
        # node child octet: table row A8[d+1] + (r - r0[d+1]) * 8^d + m
        dc = torch.clamp(d + 1, max=D)
        A8c = torch.zeros_like(d)
        r0c = torch.zeros_like(d)
        for k in range(D + 1):
            hit = dc == k
            A8c = A8c + torch.where(hit, int(self.h_A8[k]), 0).to(d.dtype)
            r0c = r0c + torch.where(hit, int(self.h_r0[k]), 0).to(d.dtype)
        tb_node = A8c + ((r - r0c) << torch.clamp(3 * d, 0, 30)) + m
        # pixel octet: half-grid box row
        bx, by, bz = self._unmorton(m)
        ox, oy, oz = self.org_of_roots(r)
        oxh = (ox >> 1) + bx
        oyh = (oy >> 1) + by
        ozh = (oz >> 1) + bz
        tb_pix = (ozh * Nh + oyh) * Nh + oxh
        tb8 = torch.where(svalid, torch.where(px_parent, tb_pix, tb_node), torch.zeros_like(tb_pix))
        v = vtab.reshape(-1, 8)[tb8.long()]
        mc = (m[:, None] << 3) + slot[None, :]
        d1 = d + 1
        db1 = torch.zeros_like(d)
        r01 = torch.zeros_like(d)
        for k in range(D + 2):
            hit = d1 == k
            db1 = db1 + torch.where(hit, int(self.h_depth_base[k]), 0).to(d.dtype)
            r01 = r01 + torch.where(hit, int(self.h_r0[k]), 0).to(d.dtype)
        cid = (
            db1[:, None]
            + ((r - r01)[:, None] << torch.clamp(3 * d1, 0, 30)[:, None])
            + mc
        )
        px = (oxh[:, None] << 1) + (slot[None, :] & 1)
        py = (oyh[:, None] << 1) + ((slot[None, :] >> 1) & 1)
        pz = (ozh[:, None] << 1) + (slot[None, :] >> 2)
        lin = (pz * N + py) * N + px
        vidx = torch.where(ispx, lin, self.n + cid)
        return cnt, rvalid, ispx, isnd, vidx, v

    def sort_paths_of(self, ids):
        """Walk-key path words: one 4-bit-digit word when depth_max <= 6
        (digit values 1..8 compare as in the 5-bit host layout), the parity
        layout otherwise."""
        if self.depth_max > 6:
            return self.paths_of(ids)
        _, d, m = self.decode(ids)
        return [self._path_word4(d, m)]

    def _path_word4(self, d, m):
        S = self.depth_max + 1
        w = torch.zeros_like(m)
        for j in range(S):
            sh = torch.clamp(3 * (d - 1 - j), min=0)
            dig = torch.where(j < d, ((m >> sh) & 7) + 1, 0).to(m.dtype)
            w = w | (dig << (4 * (S - 1 - j)))
        return w

    def sort_child_paths(self, q, rslot):
        if self.depth_max > 6:
            return self.child_paths(q, rslot)
        _, d, m = self.decode(q)
        w = self._path_word4(d, m)
        S = self.depth_max + 1
        sh = 4 * (S - 1 - d)
        return [w + ((rslot + 1) << sh)]

    def paths_of(self, ids):
        _, d, m = self.decode(ids)
        return self._path_words(d, m)

    def child_paths(self, q, rslot):
        """Path words of child slots: the parent's path with digit (slot+1)
        appended at the parent's depth."""
        _, d, m = self.decode(q)
        pw = self._path_words(d, m)
        dig = rslot + 1
        out = []
        for k in range(2):
            lo_k, hi_k = 6 * k, 6 * k + 6
            sh = torch.clamp(5 * (5 - (d - 6 * k)), 0, 25)
            in_word = (d >= lo_k) & (d < hi_k)
            out.append(pw[k] + torch.where(in_word, dig << sh, torch.zeros_like(dig)))
        return out

    def O0_full(self):
        """Dense O scratch [nn+1]: root pre-assignment ranks, zeros below."""
        return torch.cat(
            [self.O0_head, torch.zeros(self.nn + 1 - self.nroots, dtype=_I32, device=self.device)]
        )

    def anchor_plan(self):
        """Static geometry of ``dense_anchor_ranks``, built once: per depth
        the node levels (a device tensor) and the span of each level."""
        if self._anchor_plan is None:
            db = self.h_depth_base
            lev_d, spans = [], {}
            for d in range(self.depth_max + 1):
                lo, hi = int(db[d]), int(db[d + 1])
                if hi <= lo:
                    lev_d.append(None)
                    continue
                lev_np = np.repeat(self.h_rlev[int(self.h_r0[d]):], 8**d) + 3 * d
                lev_d.append(_i32(lev_np, self.device))
                for L in np.unique(lev_np):
                    idx = np.nonzero(lev_np == L)[0]
                    spans.setdefault(int(L), []).append((d, int(idx[0]), int(idx[-1]) + 1))
            self._anchor_plan = (lev_d, spans)
        return self._anchor_plan

    def walk_forest(self) -> torch.Tensor:
        """The forest's constants as the walk kernels read them (struct
        Forest of kernels/walk.cu), an int32 tensor on the index's device,
        made once."""
        if self._walk_forest is None:
            D, R = self.depth_max, self.nroots
            nd, nr = kernels.FOREST_DEPTHS, kernels.FOREST_ROOTS
            if D + 2 > nd or R > nr or self.nlev > 32:
                raise ValueError(f"the walk kernels take depth_max <= {nd - 2} and at most {nr} "
                                 f"roots; got {D}, {R}")

            def pad(a, k):
                out = np.zeros(k, dtype=np.int64)
                out[: len(a)] = a
                return out

            org = self.h_org
            host = np.concatenate([
                [self.K, self.dims[0], self.n, self.nn, D, R, self.nlev, D + 1],
                pad(self.h_depth_base, nd), pad(self.h_r0, nd), pad(self.h_A8[: D + 1], nd),
                *(pad(a, nr) for a in (self.h_slog, org[:, 0], org[:, 1], org[:, 2], self.h_rlev,
                                       self.h_O0_head)),
                pad(self.h_off0, 32),
            ])
            self._walk_forest = _i32(host, self.device)
        return self._walk_forest

    def rank_plan(self) -> "RankPlan":
        """The levels K7 ranks (every level but the leaves'), ascending, as
        the kernel reads them: per level its node count, the bit width of
        the parent ranks in its keys (the largest count of the levels below)
        and its id spans; the leading levels of at most 4,096 nodes and 21
        key bits go to one block.  Made once."""
        if self._rank_plan is None:
            _, spans = self.anchor_plan()
            db = self.h_depth_base
            ns = kernels.RANK_SPANS
            rows, counts, wks = [], [], []
            below = 0
            for L in sorted(spans):
                if self.K - L // 3 == 1:
                    continue
                sp = [(int(db[d]) + a, int(db[d]) + b) for d, a, b in spans[L]]
                if len(sp) > ns:
                    raise ValueError(f"level {L} has {len(sp)} spans; the plan holds {ns}")
                row = np.zeros(kernels.RANK_LEVEL_INTS, dtype=np.int32)
                row[0] = sum(hi - lo for lo, hi in sp)
                row[1] = below.bit_length()
                row[2] = len(sp)
                for k, (lo, hi) in enumerate(sp):
                    row[3 + k], row[3 + ns + k] = lo, hi
                rows.append(row)
                counts.append(int(row[0]))
                wks.append(int(row[1]))
                below = max(below, int(row[0]))
            nsmall = 0
            while (nsmall < len(rows) and counts[nsmall] <= kernels.RANK_SMALL_MAX
                   and 12 + wks[nsmall] <= kernels.RANK_SMALL_BITS):
                nsmall += 1
            host = np.concatenate(rows) if rows else np.zeros(0, dtype=np.int32)
            self._rank_plan = RankPlan(host, _i32(host, self.device), nsmall, tuple(counts),
                                       tuple(wks))
        return self._rank_plan


class RankPlan(NamedTuple):
    host: np.ndarray     # int32, kernels.RANK_LEVEL_INTS words per ranked level
    dev: torch.Tensor    # the same on the index's device
    nsmall: int          # leading levels ranked in one block
    counts: Tuple[int, ...]  # nodes per ranked level
    wks: Tuple[int, ...]     # bits of (parent rank + 1) in each level's keys


def child_value_table(vf: VirtualLisIndex, s: torch.Tensor, signs: torch.Tensor,
                      node_s: torch.Tensor, mags=None) -> torch.Tensor:
    """The walk's combined 8-aligned child value table: the pixels'
    clip(s, 0, 127) | sign << 7 (| min(mag, 2^23 - 1) << 8 with mags) in
    2x2x2-box-major order, then the per-depth node_s sections.  On a CUDA
    tensor one launch (``walk_vtab``); on a CPU tensor the plain version."""
    if _dispatch(s, "child_value_table"):
        return kernels.walk_vtab(s, signs.to(torch.bool), mags, node_s, vf.walk_forest(),
                                 vf.dims[0], vf.nt)
    return child_value_table_ref(vf, s, signs, node_s, mags)


def child_value_table_ref(vf: VirtualLisIndex, s: torch.Tensor, signs: torch.Tensor,
                          node_s: torch.Tensor, mags=None) -> torch.Tensor:
    """Plain ``child_value_table``: ``vtab_from(box_major_pixels(...))``."""
    pv = torch.clamp(s, 0, 127) | (signs.to(_I32) << 7)
    if mags is not None:
        pv = pv | (torch.clamp(mags, max=(1 << 23) - 1) << 8)
    return vf.vtab_from(vf.box_major_pixels(pv), node_s)


def dense_anchor_ranks(node_s: torch.Tensor, vf: VirtualLisIndex,
                       bitmap_bits: int = kernels.RANK_BITMAP_BITS) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: (J, R), each node's same-pass chain anchor and its string rank
    (``dense_anchor_ranks_ref`` defines them).  On a CUDA tensor the hand
    kernels of kernels/walk.cu (``anchor_ranks``; levels whose keys are
    wider than ``bitmap_bits`` sorted: a lower value drives that route at
    small sizes); on a CPU tensor the plain version."""
    if _dispatch(node_s, "dense_anchor_ranks"):
        plan = vf.rank_plan()
        got = kernels.anchor_ranks(node_s, vf.walk_forest(), plan.dev, plan.host, plan.nsmall,
                                   bitmap_bits=bitmap_bits)
        return got.J, got.R
    return dense_anchor_ranks_ref(node_s, vf)


def _level_ranks(key: torch.Tensor) -> torch.Tensor:
    """Dense ranks of one level's int64 keys (0 for the smallest key; equal
    keys, equal ranks): a sort, the key changes and their running count."""
    dev = key.device
    ks, perm = torch.sort(key)
    diff = torch.cat([torch.zeros(1, dtype=_I32, device=dev), (ks[1:] != ks[:-1]).to(_I32)])
    rank = torch.empty_like(diff)
    rank[perm] = torch.cumsum(diff, dim=0, dtype=_I32)
    return rank


def dense_anchor_ranks_ref(node_s: torch.Tensor, vf: VirtualLisIndex) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7, plain version: same-pass chain anchors and their string ranks,
    computed densely on the forest's per-depth slices.

      J(z) = topmost ancestor reachable through nodes with the same node_s;
      R(z) = rank, among the nodes of z's level, of the hop-word string
             [u(z), u(next z), ...] with next(z) = J(parent(z)); equal strings
             get equal ranks.

    Every parent->child propagation is a suffix slice plus a repeat; the
    ranking is one sort per level (leaf levels are skipped: their ranks are
    never read).  Returns (J [nn] int32 node ids, R [nn] int32 ranks)."""
    D = vf.depth_max
    db = vf.h_depth_base
    r0 = vf.h_r0
    dev = node_s.device
    lev_d, spans = vf.anchor_plan()

    s_d: List[torch.Tensor] = []
    J_d: List[torch.Tensor] = []
    AJL_d: List[torch.Tensor] = []   # level of J(z)
    same_d: List[torch.Tensor] = []
    u_d: List[torch.Tensor] = []
    empty = torch.zeros(0, dtype=_I32, device=dev)
    for d in range(D + 1):
        lo, hi = int(db[d]), int(db[d + 1])
        if hi <= lo:
            for lst in (s_d, J_d, AJL_d, u_d):
                lst.append(empty)
            same_d.append(torch.zeros(0, dtype=torch.bool, device=dev))
            continue
        sz = hi - lo
        sd = node_s[lo:hi]
        own = lo + torch.arange(sz, dtype=_I32, device=dev)
        lev = lev_d[d]
        if d == 0:
            same = torch.zeros(sz, dtype=torch.bool, device=dev)
            J = own
            AJL = lev
            u = vf.O0_head
        else:
            skip = (int(r0[d]) - int(r0[d - 1])) * 8 ** (d - 1)
            par_s = _bcast(s_d[d - 1][skip:], 8)
            par_J = _bcast(J_d[d - 1][skip:], 8)
            par_AJL = _bcast(AJL_d[d - 1][skip:], 8)
            same = par_s == sd
            J = torch.where(same, par_J, own)
            AJL = torch.where(same, par_AJL, lev)
            # u(z): birth pass (parent's node_s) and the level of next(z)
            u = (1 << 11) | (torch.clamp(par_s, 0, 63) << 5) | (31 - par_AJL)
        s_d.append(sd)
        J_d.append(J)
        AJL_d.append(AJL)
        same_d.append(same)
        u_d.append(u)

    RSTR_d = [torch.zeros(x.shape[0], dtype=_I32, device=dev) for x in s_d]
    ARV_d = [torch.zeros(x.shape[0], dtype=_I32, device=dev) for x in s_d]
    for L in sorted(spans):
        # leaf levels (side-2 nodes) are never anchors of born rows and their
        # ranks are never propagated
        if vf.K - L // 3 == 1:
            continue
        sp = spans[L]
        u_parts, k2_parts = [], []
        for d, a, b in sp:
            u_parts.append(u_d[d][a:b])
            if d == 0:
                k2_parts.append(torch.full((b - a,), -1, dtype=_I32, device=dev))
            else:
                skip = (int(r0[d]) - int(r0[d - 1])) * 8 ** (d - 1)
                k2_parts.append(_bcast(ARV_d[d - 1][skip:], 8)[a:b])
        u_all = torch.cat(u_parts)
        k2_all = torch.cat(k2_parts)
        # one int64 key (u, k2): u < 2^12 and -1 <= k2 < 2^31
        rank = _level_ranks((u_all.to(torch.int64) << 32) | (k2_all.to(torch.int64) + 1))
        off = 0
        for d, a, b in sp:
            rpart = rank[off : off + (b - a)]
            RSTR_d[d][a:b] = rpart
            if d == 0:
                arv = rpart
            else:
                skip = (int(r0[d]) - int(r0[d - 1])) * 8 ** (d - 1)
                par_arv = _bcast(ARV_d[d - 1][skip:], 8)[a:b]
                arv = torch.where(same_d[d][a:b], par_arv, rpart)
            ARV_d[d][a:b] = arv
            off += b - a

    J_full = torch.cat([x for x in J_d if x.shape[0]])
    R_full = torch.cat([x for x in RSTR_d if x.shape[0]])
    return J_full, R_full


_VIRTUAL: Dict[Tuple[Tuple[int, int, int], str], VirtualLisIndex] = {}


def virtual_lis_index(dims, device) -> VirtualLisIndex:
    """The index for ``dims`` on ``device``, made once and cached."""
    key = (tuple(int(d) for d in dims), str(torch.device(device)))
    vi = _VIRTUAL.get(key)
    if vi is None:
        vi = _VIRTUAL[key] = VirtualLisIndex(key[0], device)
    return vi


def box_reduce_max(vol: torch.Tensor) -> torch.Tensor:
    """(N, N, N) -> (N/2, N/2, N/2) max over aligned 2x2x2 boxes."""
    h = vol.shape[0] // 2
    return vol.reshape(h, 2, h, 2, h, 2).amax(dim=(1, 3, 5))


def box_reduce_min(vol: torch.Tensor) -> torch.Tensor:
    """(N, N, N) -> (N/2, N/2, N/2) min over aligned 2x2x2 boxes."""
    h = vol.shape[0] // 2
    return vol.reshape(h, 2, h, 2, h, 2).amin(dim=(1, 3, 5))


def _morton_flatten(box: torch.Tensor, d: int) -> torch.Tensor:
    """(L, L, L) cells, L = 2^d -> flat [L^3] in morton order (x fastest)."""
    L = box.shape[0]
    out = box.reshape(L, L, L, 1)
    P = 1
    for _ in range(d):
        h = L // 2
        v = out.reshape(h, 2, h, 2, h, 2, P).permute(0, 2, 4, 1, 3, 5, 6)
        out = v.reshape(h, h, h, 8 * P)
        L, P = h, 8 * P
    return out.reshape(-1)


def _num_bp_tensor(num_bp, device) -> torch.Tensor:
    """num_bp (an int or a tensor) as a one-element int32 tensor on device."""
    if isinstance(num_bp, torch.Tensor):
        return num_bp.to(device=device, dtype=_I32).reshape(1).contiguous()
    return torch.tensor([int(num_bp)], dtype=_I32, device=device)


def schedule_virtual(mags: torch.Tensor, vf: VirtualLisIndex):
    """K5 and K6 fused: (num_bp, s, e, nm) of a power-of-two cube, num_bp
    the largest msb+1 as an int32 0-d tensor on the device (no host wait).
    On a CUDA tensor two launches (``sched_boxmax``, ``sched_virtual``); on a
    CPU tensor the plain version, ``msbp1_device(mags).max()`` and then
    ``pixel_schedule_virtual_ref``."""
    if _dispatch(mags, "schedule_virtual"):
        pm8, M, num_bp = kernels.sched_boxmax(_words32(mags).reshape(-1), vf.K)
        s, e, nm = kernels.sched_virtual(pm8, M, num_bp, vf.nm_segs, vf.K, vf.nn)
        return num_bp, s, e, nm
    num_bp = msbp1_device(mags).max()
    return (num_bp,) + pixel_schedule_virtual_ref(mags, vf, num_bp)


def pixel_schedule_virtual(mags: torch.Tensor, vf: VirtualLisIndex, num_bp):
    """K6 with a given num_bp (an int or an int32 tensor): (s, e, node_max
    in BFS-id order).  On a CUDA tensor the kernels of ``schedule_virtual``
    (their own num_bp is not read); on a CPU tensor the plain version."""
    if _dispatch(mags, "pixel_schedule_virtual"):
        pm8, M, _ = kernels.sched_boxmax(_words32(mags).reshape(-1), vf.K)
        return kernels.sched_virtual(pm8, M, _num_bp_tensor(num_bp, mags.device), vf.nm_segs,
                                     vf.K, vf.nn)
    return pixel_schedule_virtual_ref(mags, vf, num_bp)


def pixel_schedule_virtual_ref(mags: torch.Tensor, vf: VirtualLisIndex, num_bp):
    """K6, plain version: (s, e, node_max in BFS-id order) for a power-of-two
    cube, from one morton pyramid.  The 8 morton children of a cell are
    consecutive in the finer grid's morton order, so the pyramid is one
    morton flatten of the half-grid box maxima followed by reshape(-1, 8)
    max reductions, and every root's depth-d node block is a contiguous
    slice of its grid's array."""
    N = vf.dims[0]
    K = vf.K
    pm = msbp1_device(mags)
    vol = pm.reshape(N, N, N)
    h = N // 2
    pmax = box_reduce_max(vol)

    M = [None] * K  # M[g] = morton-ordered grid-g maxima (g <= K-1)
    M[K - 1] = _morton_flatten(pmax, K - 1)
    for g in range(K - 2, -1, -1):
        M[g] = M[g + 1].reshape(-1, 8).amax(dim=1)

    parts = []
    for d in range(vf.depth_max + 1):
        r = int(vf.h_r0[d])
        while r < vf.nroots:
            s_log = int(vf.h_slog[r])
            r_end = r
            while r_end < vf.nroots and int(vf.h_slog[r_end]) == s_log:
                r_end += 1
            g = K - (s_log - d)  # grid whose cells are the depth-d boxes
            blk = 1 << (3 * d)
            run = r_end - r
            # run of 8 = big + 7 finest octants; run of 7 drops the (0,0,0)
            # corner (it belongs to deeper roots); a single big root is
            # octant 0 alone
            lo = blk if run == 7 else 0
            hi = 8 * blk if run in (7, 8) else blk
            parts.append(M[g][lo:hi])
            r = r_end
    nm = torch.cat(parts).to(_I32)

    never = torch.full_like(pm, _NEVER)
    s = torch.where(pm > 0, num_bp - pm, never).to(_I32)
    # every pixel's parent set is its aligned 2x2x2 box
    e_cell = torch.where(pmax > 0, num_bp - pmax, torch.full_like(pmax, _NEVER)).to(_I32)
    e = e_cell[:, None, :, None, :, None].expand(h, 2, h, 2, h, 2).reshape(-1)
    return s, e, nm


__all__ = [
    "VirtualLisIndex",
    "virtual_lis_index",
    "pixel_schedule_virtual",
    "pixel_schedule_virtual_ref",
    "schedule_virtual",
    "child_value_table",
    "child_value_table_ref",
    "dense_anchor_ranks",
    "dense_anchor_ranks_ref",
    "msbp1_device",
    "_is_pow2_cube",
]
