"""Minimal TrueType glyph rasterizer (glyph-ID addressed, numpy scanline).

Why this exists: the builtin PDF backend (``ingest/minipdf.py``) renders
text with PIL's FreeType binding, which looks glyphs up by UNICODE
character. PDF Type0/Identity-H fonts address glyphs by GLYPH ID, and
subset fonts routinely ship broken/absent cmaps — so unicode-addressed
rendering degrades to ToUnicode approximation (the round-2 fidelity gap,
PARITY.md). This module parses the embedded TrueType program
(`glyf`/`loca`/`head`/`maxp`) and scan-converts outlines directly by
glyph id, closing the gap for the dominant embedded-font class.
(Reference counterpart: PyMuPDF's bundled MuPDF font engine,
``/root/reference/dots_ocr/utils/doc_utils.py:20-39`` — rebuilt here
from the TrueType spec, not ported.)

Scope: quadratic outlines (TrueType `glyf`), simple + composite glyphs
(offset/scale transforms), nonzero-winding scanline fill with 3x
supersampled antialiasing. CFF (`FontFile3`/OpenType-CFF) outlines live
in the sibling ``ingest/cff.py`` (Type 2 charstring interpreter) and
share this module's scanline fill via :func:`render_contours`; use
:func:`load_glyph_font` to get whichever class matches the bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_SS = 3  # supersampling factor for antialiasing


@dataclass
class _Glyph:
    # Flattened closed contours in font units, y-up: list of [N, 2] arrays.
    contours: List[np.ndarray]
    xmin: float = 0.0
    ymin: float = 0.0
    xmax: float = 0.0
    ymax: float = 0.0


class TrueTypeFont:
    """Parsed TrueType font; rasterizes glyphs by glyph id."""

    def __init__(self, data: bytes):
        self.data = data
        self.tables: Dict[str, Tuple[int, int]] = {}
        self._parse_directory()
        head = self._table("head")
        if head is None or len(head) < 54:
            raise ValueError("no head table")
        self.units_per_em = struct.unpack(">H", head[18:20])[0] or 1000
        self.loc_format = struct.unpack(">h", head[50:52])[0]
        maxp = self._table("maxp")
        self.num_glyphs = (
            struct.unpack(">H", maxp[4:6])[0] if maxp and len(maxp) >= 6 else 0
        )
        loca = self._table("loca")
        if loca is None:
            raise ValueError("no loca table")
        if self.loc_format == 0:
            self.loca = np.frombuffer(loca, ">u2").astype(np.int64) * 2
        else:
            self.loca = np.frombuffer(loca, ">u4").astype(np.int64)
        self.glyf_off, self.glyf_len = self.tables["glyf"]
        self._glyph_cache: Dict[int, Optional[_Glyph]] = {}
        self._cmap = None

    # -- table plumbing -------------------------------------------------

    def _parse_directory(self) -> None:
        d = self.data
        if len(d) < 12:
            raise ValueError("not a TrueType font")
        tag = d[:4]
        off = 0
        if tag == b"ttcf":  # collection: take the first font
            off = struct.unpack(">I", d[12:16])[0]
            tag = d[off : off + 4]
        if tag not in (b"\x00\x01\x00\x00", b"true", b"OTTO"):
            raise ValueError(f"unsupported font magic {tag!r}")
        if tag == b"OTTO":
            raise ValueError("CFF outlines (OTTO) unsupported")
        (num_tables,) = struct.unpack(">H", d[off + 4 : off + 6])
        for i in range(num_tables):
            rec = d[off + 12 + 16 * i : off + 12 + 16 * (i + 1)]
            if len(rec) < 16:
                break
            name = rec[:4].decode("latin-1")
            t_off, t_len = struct.unpack(">II", rec[8:16])
            self.tables[name] = (t_off, t_len)
        if "glyf" not in self.tables or "loca" not in self.tables:
            raise ValueError("no glyf/loca (CFF font?)")

    def _table(self, name: str) -> Optional[bytes]:
        if name not in self.tables:
            return None
        off, length = self.tables[name]
        return self.data[off : off + length]

    # -- cmap (for unicode-addressed callers / tests) -------------------

    def glyph_id_for_char(self, ch: str) -> int:
        """Unicode codepoint -> glyph id via cmap format 4/12 (0 if absent)."""
        if self._cmap is None:
            self._cmap = parse_cmap(self._table("cmap"))
        return self._cmap.get(ord(ch), 0)

    # -- outlines -------------------------------------------------------

    def _glyph(self, gid: int, depth: int = 0) -> Optional[_Glyph]:
        if gid in self._glyph_cache:
            return self._glyph_cache[gid]
        g = self._load_glyph(gid, depth)
        self._glyph_cache[gid] = g
        return g

    def _load_glyph(self, gid: int, depth: int) -> Optional[_Glyph]:
        if gid < 0 or gid + 1 >= len(self.loca) or depth > 4:
            return None
        start, end = int(self.loca[gid]), int(self.loca[gid + 1])
        if end <= start:
            return _Glyph([], 0, 0, 0, 0)  # empty glyph (e.g. space)
        d = self.data[self.glyf_off + start : self.glyf_off + end]
        if len(d) < 10:
            return None
        n_contours, xmin, ymin, xmax, ymax = struct.unpack(">hhhhh", d[:10])
        if n_contours >= 0:
            contours = self._simple_contours(d, n_contours)
        else:
            contours = self._composite_contours(d, depth)
        if contours is None:
            return None
        return _Glyph(contours, xmin, ymin, xmax, ymax)

    def _simple_contours(
        self, d: bytes, n_contours: int
    ) -> Optional[List[np.ndarray]]:
        pos = 10
        if pos + 2 * n_contours + 2 > len(d):
            return None
        end_pts = struct.unpack(f">{n_contours}H", d[pos : pos + 2 * n_contours])
        pos += 2 * n_contours
        (instr_len,) = struct.unpack(">H", d[pos : pos + 2])
        pos += 2 + instr_len
        n_points = (end_pts[-1] + 1) if n_contours else 0

        # flags (run-length by REPEAT)
        flags = []
        while len(flags) < n_points and pos < len(d):
            f = d[pos]
            pos += 1
            flags.append(f)
            if f & 8 and pos < len(d):  # REPEAT
                r = d[pos]
                pos += 1
                flags.extend([f] * r)
        if len(flags) < n_points:
            return None
        flags = flags[:n_points]

        def read_coords(short_bit: int, same_bit: int) -> List[int]:
            nonlocal pos
            vals = []
            v = 0
            for f in flags:
                if f & short_bit:
                    if pos >= len(d):
                        return vals
                    delta = d[pos]
                    pos += 1
                    v += delta if f & same_bit else -delta
                elif not f & same_bit:
                    if pos + 2 > len(d):
                        return vals
                    v += struct.unpack(">h", d[pos : pos + 2])[0]
                    pos += 2
                vals.append(v)
            return vals

        xs = read_coords(2, 16)
        ys = read_coords(4, 32)
        if len(xs) < n_points or len(ys) < n_points:
            return None
        on = [bool(f & 1) for f in flags]

        contours: List[np.ndarray] = []
        start = 0
        for ep in end_pts:
            pts = [(xs[i], ys[i], on[i]) for i in range(start, ep + 1)]
            start = ep + 1
            poly = _flatten_contour(pts)
            if len(poly) >= 3:
                contours.append(np.asarray(poly, np.float64))
        return contours

    def _composite_contours(
        self, d: bytes, depth: int
    ) -> Optional[List[np.ndarray]]:
        pos = 10
        out: List[np.ndarray] = []
        while True:
            if pos + 4 > len(d):
                break
            flags, comp_gid = struct.unpack(">HH", d[pos : pos + 4])
            pos += 4
            if flags & 1:  # ARG_1_AND_2_ARE_WORDS
                if pos + 4 > len(d):
                    break
                a1, a2 = struct.unpack(">hh", d[pos : pos + 4])
                pos += 4
            else:
                if pos + 2 > len(d):
                    break
                a1, a2 = struct.unpack(">bb", d[pos : pos + 2])
                pos += 2
            sx = sy = 1.0
            s01 = s10 = 0.0
            if flags & 8:  # WE_HAVE_A_SCALE
                sx = sy = _f2dot14(d, pos)
                pos += 2
            elif flags & 0x40:  # X_AND_Y_SCALE
                sx = _f2dot14(d, pos)
                sy = _f2dot14(d, pos + 2)
                pos += 4
            elif flags & 0x80:  # 2x2 transform
                sx = _f2dot14(d, pos)
                s01 = _f2dot14(d, pos + 2)
                s10 = _f2dot14(d, pos + 4)
                sy = _f2dot14(d, pos + 6)
                pos += 8
            dx, dy = (a1, a2) if flags & 2 else (0, 0)  # ARGS_ARE_XY_VALUES
            sub = self._glyph(comp_gid, depth + 1)
            if sub is not None:
                for poly in sub.contours:
                    x = poly[:, 0] * sx + poly[:, 1] * s10 + dx
                    y = poly[:, 0] * s01 + poly[:, 1] * sy + dy
                    out.append(np.stack([x, y], axis=1))
            if not flags & 0x20:  # MORE_COMPONENTS
                break
        return out

    # -- rasterization --------------------------------------------------

    def render_glyph(self, gid: int, px: float) -> Tuple[Optional[np.ndarray], float, float]:
        """Rasterize glyph ``gid`` at ``px`` pixels per em.

        Returns (alpha uint8 [H, W] or None for empty/missing glyphs,
        x_bearing_px, y_top_px) where the bitmap's top-left sits at
        (x_bearing, -y_top) relative to the BASELINE origin (y down).
        """
        g = self._glyph(gid)
        if g is None or not g.contours:
            return None, 0.0, 0.0
        return render_contours(g.contours, self.units_per_em, px)


def render_contours(
    contours: List[np.ndarray], units_per_em: float, px: float
) -> Tuple[Optional[np.ndarray], float, float]:
    """Scan-convert closed font-unit contours ([N, 2] float arrays, y-up)
    at ``px`` pixels per em. Shared by the TrueType (quadratic) and CFF
    (cubic, ``ingest/cff.py``) outline front ends. Returns
    (alpha uint8 [H, W] | None, x_bearing_px, y_top_px) as in
    :meth:`TrueTypeFont.render_glyph`."""
    if not contours:
        return None, 0.0, 0.0
    scale = px / units_per_em
    xs = np.concatenate([c[:, 0] for c in contours]) * scale
    ys = np.concatenate([c[:, 1] for c in contours]) * scale
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    w = max(1, int(np.ceil(x1 - x0)) + 2)
    h = max(1, int(np.ceil(y1 - y0)) + 2)
    if w * h > 4096 * 4096:
        return None, 0.0, 0.0
    # Supersampled nonzero-winding scanline fill, y-down device space.
    W, H = w * _SS, h * _SS
    acc = np.zeros((H, W), np.int16)
    y_rows = (np.arange(H) + 0.5) / _SS  # device y within bitmap
    for c in contours:
        px_x = c[:, 0] * scale - x0 + 1.0
        px_y = (y1 - c[:, 1] * scale) + 1.0  # flip to y-down
        x_a, y_a = px_x, px_y
        x_b, y_b = np.roll(px_x, -1), np.roll(px_y, -1)
        for xa, ya, xb, yb in zip(x_a, y_a, x_b, y_b):
            if ya == yb:
                continue
            direction = 1 if yb > ya else -1
            ylo, yhi = (ya, yb) if ya < yb else (yb, ya)
            rows = np.nonzero((y_rows >= ylo) & (y_rows < yhi))[0]
            if len(rows) == 0:
                continue
            t = (y_rows[rows] - ya) / (yb - ya)
            xc = xa + t * (xb - xa)
            cols = np.clip(np.round(xc * _SS).astype(np.int64), 0, W)
            for r, ccol in zip(rows, cols):
                if ccol < W:
                    acc[r, ccol] += direction
    inside = np.cumsum(acc, axis=1) != 0  # nonzero winding
    alpha = inside.reshape(h, _SS, w, _SS).mean(axis=(1, 3))
    bitmap = (alpha * 255.0 + 0.5).astype(np.uint8)
    return bitmap, x0 - 1.0, y1 + 1.0


def parse_cmap(cmap: Optional[bytes]) -> Dict[int, int]:
    """sfnt `cmap` table bytes -> {codepoint: glyph id} (formats 4/12).

    Module-level so OpenType-CFF fonts (``ingest/cff.py``) can reuse the
    same unicode lookup over their sfnt wrapper's cmap.
    """
    out: Dict[int, int] = {}
    if not cmap or len(cmap) < 4:
        return out
    (n,) = struct.unpack(">H", cmap[2:4])
    subtable = None
    for i in range(n):
        rec = cmap[4 + 8 * i : 4 + 8 * (i + 1)]
        if len(rec) < 8:
            break
        pid, eid, off = struct.unpack(">HHI", rec)
        if (pid, eid) in ((3, 10), (0, 4), (0, 6)):
            subtable = off  # UCS-4 preferred
            break
        if (pid, eid) in ((3, 1), (0, 3), (0, 2), (0, 1)):
            subtable = off
    if subtable is None or subtable + 2 > len(cmap):
        return out
    (fmt,) = struct.unpack(">H", cmap[subtable : subtable + 2])
    if fmt == 4:
        seg_x2 = struct.unpack(">H", cmap[subtable + 6 : subtable + 8])[0]
        seg = seg_x2 // 2
        base = subtable + 14
        ends = np.frombuffer(cmap[base : base + seg_x2], ">u2")
        starts = np.frombuffer(
            cmap[base + seg_x2 + 2 : base + 2 * seg_x2 + 2], ">u2"
        )
        deltas = np.frombuffer(
            cmap[base + 2 * seg_x2 + 2 : base + 3 * seg_x2 + 2], ">i2"
        )
        range_off_pos = base + 3 * seg_x2 + 2
        range_offs = np.frombuffer(
            cmap[range_off_pos : range_off_pos + seg_x2], ">u2"
        )
        for i in range(seg):
            for c in range(int(starts[i]), int(ends[i]) + 1):
                if c == 0xFFFF:
                    continue
                if range_offs[i] == 0:
                    g = (c + int(deltas[i])) & 0xFFFF
                else:
                    p = (
                        range_off_pos + 2 * i + int(range_offs[i])
                        + 2 * (c - int(starts[i]))
                    )
                    if p + 2 > len(cmap):
                        continue
                    (g,) = struct.unpack(">H", cmap[p : p + 2])
                    if g:
                        g = (g + int(deltas[i])) & 0xFFFF
                if g:
                    out[c] = g
    elif fmt == 12:
        (ngroups,) = struct.unpack(
            ">I", cmap[subtable + 12 : subtable + 16]
        )
        for i in range(ngroups):
            rec = cmap[subtable + 16 + 12 * i : subtable + 16 + 12 * (i + 1)]
            if len(rec) < 12:
                break
            start, end, gstart = struct.unpack(">III", rec)
            for c in range(start, min(end, start + 0x10000) + 1):
                out[c] = gstart + (c - start)
    return out


def load_glyph_font(data: bytes):
    """Parse embedded font bytes into whichever glyph-id rasterizer fits:
    TrueType (`glyf` outlines, incl. ttc collections) or CFF
    (bare `FontFile3` Type1C/CIDFontType0C payloads and OpenType `OTTO`
    wrappers — ``ingest/cff.py``). Raises ValueError when neither can
    parse the bytes (callers fall back to PIL rendering)."""
    try:
        return TrueTypeFont(data)
    except Exception:
        from dots_ocr_tpu_torch.ingest.cff import CFFFont

        return CFFFont(data)


def _f2dot14(d: bytes, pos: int) -> float:
    if pos + 2 > len(d):
        return 1.0
    (v,) = struct.unpack(">h", d[pos : pos + 2])
    return v / 16384.0


def _flatten_contour(
    pts: List[Tuple[float, float, bool]], steps: int = 8
) -> List[Tuple[float, float]]:
    """TrueType contour (on/off points, implied midpoints) -> polyline."""
    if not pts:
        return []
    # Rotate so the contour starts on-curve (insert a midpoint if none).
    if not any(p[2] for p in pts):
        first = (
            (pts[0][0] + pts[-1][0]) / 2.0,
            (pts[0][1] + pts[-1][1]) / 2.0,
            True,
        )
        pts = [first] + pts
    else:
        k = next(i for i, p in enumerate(pts) if p[2])
        pts = pts[k:] + pts[:k]

    out: List[Tuple[float, float]] = [(pts[0][0], pts[0][1])]
    i = 1
    n = len(pts)
    ts = np.linspace(0.0, 1.0, steps + 1)[1:]
    cur = (pts[0][0], pts[0][1])
    while i <= n:
        p = pts[i % n]
        if p[2]:  # on-curve: straight segment
            out.append((p[0], p[1]))
            cur = (p[0], p[1])
            i += 1
            continue
        # off-curve control: next on-curve point (implied midpoint if the
        # next is also off-curve)
        q = pts[(i + 1) % n]
        if q[2]:
            end = (q[0], q[1])
            i += 2
        else:
            end = ((p[0] + q[0]) / 2.0, (p[1] + q[1]) / 2.0)
            i += 1
        for t in ts:
            x = (1 - t) ** 2 * cur[0] + 2 * (1 - t) * t * p[0] + t * t * end[0]
            y = (1 - t) ** 2 * cur[1] + 2 * (1 - t) * t * p[1] + t * t * end[1]
            out.append((x, y))
        cur = end
    return out
