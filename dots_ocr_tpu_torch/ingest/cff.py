"""Minimal CFF / Type 2 charstring rasterizer (glyph-ID addressed).

Companion to ``ingest/ttf.py``: that module scan-converts TrueType
`glyf` quadratics; this one interprets CFF Type 2 charstrings (cubic
béziers) for the OTHER embedded-font class PDFs ship — `FontFile3`
(Subtype Type1C / CIDFontType0C, a bare CFF payload) and OpenType-CFF
(`OTTO` sfnt wrappers). Both front ends share the same supersampled
nonzero-winding scanline fill (:func:`ttf.render_contours`), so the
builtin PDF backend renders either outline flavor by GLYPH ID instead of
falling back to PIL's unicode-addressed cmap lookup (the round-2/3
fidelity gap for CFF fonts, PARITY.md). Reference counterpart: MuPDF's
font engine behind PyMuPDF (``/root/reference/dots_ocr/utils/
doc_utils.py:20-39``) — rebuilt from the Adobe CFF (5176) and Type 2
charstring (5177) specs, not ported.

Scope: CFF1 INDEX/DICT plumbing, Type 2 interpreter (all path +
flex operators, local/global subrs with bias, seac-style endchar accent
composition), CID-keyed fonts (charset CID→GID, FDArray/FDSelect
per-glyph private dicts). Out of scope: CFF2 variable fonts, Type 1
(`FontFile`) charstrings, hint interpretation (hints are parsed and
skipped — the fill is unhinted, same policy as the TrueType side).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from dots_ocr_tpu_torch.ingest.ttf import parse_cmap, render_contours

# Number of line segments a cubic bézier is flattened into (matches the
# quadratic flattening density in ttf.py at text sizes).
_CURVE_STEPS = 8

# CFF standard strings 1..95 are exactly the StandardEncoding glyph
# names for ASCII 32..126 in codepoint order ('space', 'exclam', ...,
# 'asciitilde'), so SID == code - 31 on that range. That identity is all
# `glyph_id_for_char` needs for unicode lookups into bare-CFF fonts
# (OTTO wrappers prefer their sfnt cmap) and for seac accent bases.
_ASCII_SID = lambda cp: cp - 31 if 32 <= cp <= 126 else None  # noqa: E731


def _read_index(d: bytes, pos: int) -> Tuple[List[bytes], int]:
    """CFF INDEX at ``pos`` -> (items, position after the INDEX)."""
    if pos + 2 > len(d):
        raise ValueError("truncated INDEX")
    (count,) = struct.unpack(">H", d[pos : pos + 2])
    if count == 0:
        return [], pos + 2
    off_size = d[pos + 2]
    if not 1 <= off_size <= 4:
        raise ValueError(f"bad INDEX offSize {off_size}")
    base = pos + 3
    offs = []
    for i in range(count + 1):
        chunk = d[base + i * off_size : base + (i + 1) * off_size]
        if len(chunk) < off_size:
            raise ValueError("truncated INDEX offsets")
        offs.append(int.from_bytes(chunk, "big"))
    data_base = base + (count + 1) * off_size - 1  # offsets are 1-based
    items = [d[data_base + offs[i] : data_base + offs[i + 1]] for i in range(count)]
    end = data_base + offs[-1]
    if end > len(d):
        raise ValueError("INDEX data past end")
    return items, end


def _parse_dict(d: bytes) -> Dict[int, List[float]]:
    """CFF DICT bytes -> {op: operands}; two-byte ops keyed as 0xc00 | op2."""
    out: Dict[int, List[float]] = {}
    operands: List[float] = []
    i = 0
    n = len(d)
    while i < n:
        b0 = d[i]
        if b0 <= 21:  # operator
            if b0 == 12:
                if i + 1 >= n:
                    break
                out[0xC00 | d[i + 1]] = operands
                i += 2
            else:
                out[b0] = operands
                i += 1
            operands = []
        elif 32 <= b0 <= 246:
            operands.append(b0 - 139)
            i += 1
        elif 247 <= b0 <= 250:
            operands.append((b0 - 247) * 256 + d[i + 1] + 108)
            i += 2
        elif 251 <= b0 <= 254:
            operands.append(-(b0 - 251) * 256 - d[i + 1] - 108)
            i += 2
        elif b0 == 28:
            operands.append(struct.unpack(">h", d[i + 1 : i + 3])[0])
            i += 3
        elif b0 == 29:
            operands.append(struct.unpack(">i", d[i + 1 : i + 5])[0])
            i += 5
        elif b0 == 30:  # real number, packed nibbles
            s = ""
            i += 1
            done = False
            while i < n and not done:
                for nib in (d[i] >> 4, d[i] & 0xF):
                    if nib <= 9:
                        s += str(nib)
                    elif nib == 0xA:
                        s += "."
                    elif nib == 0xB:
                        s += "E"
                    elif nib == 0xC:
                        s += "E-"
                    elif nib == 0xE:
                        s += "-"
                    elif nib == 0xF:
                        done = True
                        break
                i += 1
            try:
                operands.append(float(s or "0"))
            except ValueError:
                operands.append(0.0)
        else:
            i += 1  # reserved byte: skip
    return out


def _subr_bias(n: int) -> int:
    return 107 if n < 1240 else (1131 if n < 33900 else 32768)


class CFFFont:
    """Parsed CFF font; rasterizes Type 2 charstrings by glyph id.

    Accepts a bare CFF payload (PDF ``FontFile3``) or a full OpenType
    file with ``OTTO`` magic (the CFF table is extracted; the sfnt cmap,
    when present, backs :meth:`glyph_id_for_char`). Interface mirrors
    :class:`ttf.TrueTypeFont` (`units_per_em`, `num_glyphs`,
    `render_glyph`, `glyph_id_for_char`) plus :meth:`gid_for_cid` for
    CID-keyed fonts, where the charset — not /CIDToGIDMap — defines the
    CID→GID mapping (PDF 32000-1 §9.7.4.2).
    """

    def __init__(self, data: bytes):
        self._sfnt_cmap: Optional[bytes] = None
        if data[:4] == b"OTTO":
            data = self._unwrap_otto(data)
        if len(data) < 4 or data[0] != 1:
            raise ValueError("not a CFF1 payload")
        self.data = data
        hdr_size = data[2]
        pos = hdr_size
        _names, pos = _read_index(data, pos)
        top_dicts, pos = _read_index(data, pos)
        self._strings, pos = _read_index(data, pos)
        self._gsubrs, _ = _read_index(data, pos)
        if not top_dicts:
            raise ValueError("no Top DICT")
        top = _parse_dict(top_dicts[0])
        self.is_cid = 0xC1E in top  # ROS

        cs_off = top.get(17)
        if not cs_off:
            raise ValueError("no CharStrings")
        self._charstrings, _ = _read_index(data, int(cs_off[0]))
        self.num_glyphs = len(self._charstrings)

        matrix = top.get(0xC07, [0.001, 0, 0, 0.001, 0, 0])
        self.units_per_em = 1.0 / matrix[0] if matrix[0] else 1000.0

        # Private DICT(s) -> local subrs. CID fonts route per glyph
        # through FDSelect into FDArray font dicts; plain fonts have one.
        self._fd_subrs: List[List[bytes]] = []
        self._fd_select: Optional[np.ndarray] = None
        if self.is_cid and 0xC24 in top:
            fd_dicts, _ = _read_index(data, int(top[0xC24][0]))
            for fd in fd_dicts:
                self._fd_subrs.append(self._local_subrs(_parse_dict(fd)))
            if 0xC25 in top:
                self._fd_select = self._parse_fdselect(int(top[0xC25][0]))
        else:
            self._fd_subrs.append(self._local_subrs(top))

        # charset: gid -> SID (plain) / CID (CID-keyed); gid 0 = .notdef.
        self._charset = self._parse_charset(int(top.get(15, [0])[0]))
        self._sid_to_gid: Optional[Dict[int, int]] = None
        self._contour_cache: Dict[int, List[np.ndarray]] = {}
        self._cmap: Optional[Dict[int, int]] = None

    # -- container plumbing --------------------------------------------

    def _unwrap_otto(self, d: bytes) -> bytes:
        (num_tables,) = struct.unpack(">H", d[4:6])
        cff = None
        for i in range(num_tables):
            rec = d[12 + 16 * i : 12 + 16 * (i + 1)]
            if len(rec) < 16:
                break
            tag = rec[:4]
            off, length = struct.unpack(">II", rec[8:16])
            if tag == b"CFF ":
                cff = d[off : off + length]
            elif tag == b"cmap":
                self._sfnt_cmap = d[off : off + length]
        if cff is None:
            raise ValueError("OTTO file without a CFF table")
        return cff

    def _local_subrs(self, font_dict: Dict[int, List[float]]) -> List[bytes]:
        priv = font_dict.get(18)
        if not priv or len(priv) < 2:
            return []
        size, off = int(priv[0]), int(priv[1])
        pdict = _parse_dict(self.data[off : off + size])
        if 19 not in pdict:
            return []
        subrs, _ = _read_index(self.data, off + int(pdict[19][0]))
        return subrs

    def _parse_fdselect(self, pos: int) -> Optional[np.ndarray]:
        d = self.data
        if pos >= len(d):
            return None
        fmt = d[pos]
        sel = np.zeros(self.num_glyphs, np.int32)
        if fmt == 0:
            arr = np.frombuffer(
                d[pos + 1 : pos + 1 + self.num_glyphs], np.uint8
            )
            sel[: len(arr)] = arr
        elif fmt == 3:
            (n_ranges,) = struct.unpack(">H", d[pos + 1 : pos + 3])
            p = pos + 3
            for _ in range(n_ranges):
                first, fd = struct.unpack(">HB", d[p : p + 3])
                (next_first,) = struct.unpack(">H", d[p + 3 : p + 5])
                sel[first : min(next_first, self.num_glyphs)] = fd
                p += 3
        else:
            return None
        return sel

    def _parse_charset(self, pos: int) -> np.ndarray:
        """gid -> SID/CID array. Predefined charsets (offset 0/1/2) are
        identity for our purposes (ISOAdobe assigns SID == gid)."""
        out = np.arange(self.num_glyphs, dtype=np.int64)
        if pos in (0, 1, 2) or pos >= len(self.data):
            return out
        d = self.data
        fmt = d[pos]
        gid = 1  # gid 0 is always .notdef (SID 0)
        out[0] = 0
        p = pos + 1
        try:
            if fmt == 0:
                while gid < self.num_glyphs:
                    out[gid] = struct.unpack(">H", d[p : p + 2])[0]
                    p += 2
                    gid += 1
            elif fmt in (1, 2):
                step = 3 if fmt == 1 else 4
                while gid < self.num_glyphs:
                    first = struct.unpack(">H", d[p : p + 2])[0]
                    n_left = (
                        d[p + 2]
                        if fmt == 1
                        else struct.unpack(">H", d[p + 2 : p + 4])[0]
                    )
                    p += step
                    for k in range(n_left + 1):
                        if gid >= self.num_glyphs:
                            break
                        out[gid] = first + k
                        gid += 1
        except (struct.error, IndexError):
            pass  # truncated charset: keep identity for the tail
        return out

    # -- glyph addressing ----------------------------------------------

    def gid_for_cid(self, cid: int) -> int:
        """CID -> glyph id via the charset (identity for non-CID fonts)."""
        if not self.is_cid:
            return cid
        if self._sid_to_gid is None:
            self._sid_to_gid = {
                int(s): g for g, s in enumerate(self._charset)
            }
        return self._sid_to_gid.get(cid, 0)

    def glyph_id_for_char(self, ch: str) -> int:
        """Unicode -> glyph id: sfnt cmap when wrapped in OTTO, else the
        StandardEncoding/standard-strings identity for ASCII (0 if absent)."""
        if self._sfnt_cmap is not None:
            if self._cmap is None:
                self._cmap = parse_cmap(self._sfnt_cmap)
            return self._cmap.get(ord(ch), 0)
        sid = _ASCII_SID(ord(ch))
        if sid is None:
            return 0
        if self._sid_to_gid is None:
            self._sid_to_gid = {
                int(s): g for g, s in enumerate(self._charset)
            }
        return self._sid_to_gid.get(sid, 0)

    # -- rasterization --------------------------------------------------

    def render_glyph(
        self, gid: int, px: float
    ) -> Tuple[Optional[np.ndarray], float, float]:
        """Rasterize glyph ``gid`` at ``px`` pixels per em; same contract
        as :meth:`ttf.TrueTypeFont.render_glyph`."""
        contours = self._contours(gid)
        if not contours:
            return None, 0.0, 0.0
        return render_contours(contours, self.units_per_em, px)

    def _contours(self, gid: int, depth: int = 0) -> List[np.ndarray]:
        if gid in self._contour_cache:
            return self._contour_cache[gid]
        if not 0 <= gid < self.num_glyphs or depth > 2:
            return []
        subrs = self._fd_subrs[0] if self._fd_subrs else []
        if self._fd_select is not None and gid < len(self._fd_select):
            fd = int(self._fd_select[gid])
            if 0 <= fd < len(self._fd_subrs):
                subrs = self._fd_subrs[fd]
        interp = _Type2Interp(self._charstrings[gid], subrs, self._gsubrs)
        try:
            contours = interp.run()
        except Exception:
            contours = []
        if interp.seac is not None and depth <= 2:
            contours = contours + self._seac_contours(interp.seac, depth)
        out = [np.asarray(c, np.float64) for c in contours if len(c) >= 3]
        self._contour_cache[gid] = out
        return out

    def _seac_contours(
        self, seac: Tuple[float, float, int, int], depth: int
    ) -> List[List[Tuple[float, float]]]:
        """endchar accent composition: base + shifted accent, both looked
        up through StandardEncoding codes (Type 2 spec, Appendix C)."""
        adx, ady, bchar, achar = seac
        out: List[List[Tuple[float, float]]] = []
        for code, dx, dy in ((bchar, 0.0, 0.0), (achar, adx, ady)):
            sid = _ASCII_SID(int(code))
            if sid is None:
                continue
            if self._sid_to_gid is None:
                self._sid_to_gid = {
                    int(s): g for g, s in enumerate(self._charset)
                }
            sub_gid = self._sid_to_gid.get(sid, 0)
            for c in self._contours(sub_gid, depth + 1):
                out.append([(x + dx, y + dy) for x, y in c])
        return out


class _Type2Interp:
    """One-shot Type 2 charstring executor -> flattened contours."""

    def __init__(self, code: bytes, subrs: List[bytes], gsubrs: List[bytes]):
        self.code = code
        self.subrs = subrs
        self.gsubrs = gsubrs
        self.lbias = _subr_bias(len(subrs))
        self.gbias = _subr_bias(len(gsubrs))
        self.stack: List[float] = []
        self.x = 0.0
        self.y = 0.0
        self.contours: List[List[Tuple[float, float]]] = []
        self.current: List[Tuple[float, float]] = []
        self.n_stems = 0
        self.width_done = False
        self.finished = False
        self.seac: Optional[Tuple[float, float, int, int]] = None
        self.trans: List[float] = []  # transient array (put/get); rare

    # path helpers ------------------------------------------------------

    def _moveto(self, dx: float, dy: float) -> None:
        if len(self.current) >= 3:
            self.contours.append(self.current)
        self.x += dx
        self.y += dy
        self.current = [(self.x, self.y)]

    def _lineto(self, dx: float, dy: float) -> None:
        self.x += dx
        self.y += dy
        self.current.append((self.x, self.y))

    def _curveto(
        self, dx1, dy1, dx2, dy2, dx3, dy3  # type: ignore[no-untyped-def]
    ) -> None:
        x0, y0 = self.x, self.y
        x1, y1 = x0 + dx1, y0 + dy1
        x2, y2 = x1 + dx2, y1 + dy2
        x3, y3 = x2 + dx3, y2 + dy3
        for i in range(1, _CURVE_STEPS + 1):
            t = i / _CURVE_STEPS
            u = 1.0 - t
            self.current.append(
                (
                    u * u * u * x0 + 3 * u * u * t * x1
                    + 3 * u * t * t * x2 + t * t * t * x3,
                    u * u * u * y0 + 3 * u * u * t * y1
                    + 3 * u * t * t * y2 + t * t * t * y3,
                )
            )
        self.x, self.y = x3, y3

    def _take_width(self, parity_even: bool) -> None:
        """Drop the optional leading width argument on the FIRST
        stack-clearing operator (stems/moveto/endchar take an even /
        fixed argument count; one extra means a width precedes)."""
        if not self.width_done:
            self.width_done = True
            if parity_even and len(self.stack) % 2 == 1:
                del self.stack[0]

    # execution ---------------------------------------------------------

    def run(self) -> List[List[Tuple[float, float]]]:
        self._exec(self.code, 0)
        if len(self.current) >= 3:
            self.contours.append(self.current)
        return self.contours

    def _exec(self, code: bytes, depth: int) -> None:
        if depth > 10:
            raise ValueError("subr recursion too deep")
        i = 0
        n = len(code)
        st = self.stack
        while i < n and not self.finished:
            b0 = code[i]
            if b0 >= 32 or b0 == 28:
                if 32 <= b0 <= 246:
                    st.append(b0 - 139)
                    i += 1
                elif 247 <= b0 <= 250:
                    st.append((b0 - 247) * 256 + code[i + 1] + 108)
                    i += 2
                elif 251 <= b0 <= 254:
                    st.append(-(b0 - 251) * 256 - code[i + 1] - 108)
                    i += 2
                elif b0 == 28:
                    st.append(struct.unpack(">h", code[i + 1 : i + 3])[0])
                    i += 3
                else:  # 255: 16.16 fixed
                    st.append(
                        struct.unpack(">i", code[i + 1 : i + 5])[0] / 65536.0
                    )
                    i += 5
                continue
            i += 1
            if b0 in (1, 3, 18, 23):  # h/v stem (hm)
                self._take_width(parity_even=True)
                self.n_stems += len(st) // 2
                st.clear()
            elif b0 in (19, 20):  # hintmask / cntrmask
                self._take_width(parity_even=True)
                self.n_stems += len(st) // 2  # implicit vstem args
                st.clear()
                i += (self.n_stems + 7) // 8
            elif b0 == 21:  # rmoveto
                if not self.width_done and len(st) > 2:
                    del st[0]
                self.width_done = True
                if len(st) >= 2:
                    self._moveto(st[-2], st[-1])
                st.clear()
            elif b0 == 22:  # hmoveto
                if not self.width_done and len(st) > 1:
                    del st[0]
                self.width_done = True
                if st:
                    self._moveto(st[-1], 0.0)
                st.clear()
            elif b0 == 4:  # vmoveto
                if not self.width_done and len(st) > 1:
                    del st[0]
                self.width_done = True
                if st:
                    self._moveto(0.0, st[-1])
                st.clear()
            elif b0 == 5:  # rlineto
                for k in range(0, len(st) - 1, 2):
                    self._lineto(st[k], st[k + 1])
                st.clear()
            elif b0 in (6, 7):  # hlineto / vlineto (alternating)
                horiz = b0 == 6
                for v in st:
                    self._lineto(v, 0.0) if horiz else self._lineto(0.0, v)
                    horiz = not horiz
                st.clear()
            elif b0 == 8:  # rrcurveto
                for k in range(0, len(st) - 5, 6):
                    self._curveto(*st[k : k + 6])
                st.clear()
            elif b0 == 24:  # rcurveline
                k = 0
                while len(st) - k >= 8:
                    self._curveto(*st[k : k + 6])
                    k += 6
                if len(st) - k >= 2:
                    self._lineto(st[k], st[k + 1])
                st.clear()
            elif b0 == 25:  # rlinecurve
                k = 0
                while len(st) - k > 6:
                    self._lineto(st[k], st[k + 1])
                    k += 2
                if len(st) - k >= 6:
                    self._curveto(*st[k : k + 6])
                st.clear()
            elif b0 == 26:  # vvcurveto
                k = 0
                dx1 = 0.0
                if len(st) % 4 == 1:
                    dx1 = st[0]
                    k = 1
                while len(st) - k >= 4:
                    self._curveto(dx1, st[k], st[k + 1], st[k + 2], 0.0, st[k + 3])
                    dx1 = 0.0
                    k += 4
                st.clear()
            elif b0 == 27:  # hhcurveto
                k = 0
                dy1 = 0.0
                if len(st) % 4 == 1:
                    dy1 = st[0]
                    k = 1
                while len(st) - k >= 4:
                    self._curveto(st[k], dy1, st[k + 1], st[k + 2], st[k + 3], 0.0)
                    dy1 = 0.0
                    k += 4
                st.clear()
            elif b0 in (30, 31):  # vhcurveto / hvcurveto
                horiz = b0 == 31
                k = 0
                while len(st) - k >= 4:
                    last = len(st) - k < 8
                    d5 = st[k + 4] if last and len(st) - k == 5 else 0.0
                    if horiz:
                        self._curveto(st[k], 0.0, st[k + 1], st[k + 2], d5, st[k + 3])
                    else:
                        self._curveto(0.0, st[k], st[k + 1], st[k + 2], st[k + 3], d5)
                    horiz = not horiz
                    k += 4
                st.clear()
            elif b0 == 10:  # callsubr
                if st:
                    idx = int(st.pop()) + self.lbias
                    if 0 <= idx < len(self.subrs):
                        self._exec(self.subrs[idx], depth + 1)
            elif b0 == 29:  # callgsubr
                if st:
                    idx = int(st.pop()) + self.gbias
                    if 0 <= idx < len(self.gsubrs):
                        self._exec(self.gsubrs[idx], depth + 1)
            elif b0 == 11:  # return
                return
            elif b0 == 14:  # endchar (optionally seac accent args)
                if not self.width_done and len(st) in (1, 5):
                    del st[0]
                self.width_done = True
                if len(st) >= 4:
                    self.seac = (st[-4], st[-3], int(st[-2]), int(st[-1]))
                st.clear()
                self.finished = True
            elif b0 == 12:  # escaped operators
                if i >= n:
                    break
                b1 = code[i]
                i += 1
                i = self._escape(b1, code, i)
            else:
                st.clear()  # reserved: treat as stack-clearing no-op

    def _escape(self, b1: int, code: bytes, i: int) -> int:
        st = self.stack
        if b1 == 35 and len(st) >= 13:  # flex
            self._curveto(*st[0:6])
            self._curveto(*st[6:12])
            st.clear()
        elif b1 == 34 and len(st) >= 7:  # hflex
            dx1, dx2, dy2, dx3, dx4, dx5, dx6 = st[:7]
            y0 = self.y
            self._curveto(dx1, 0.0, dx2, dy2, dx3, 0.0)
            self._curveto(dx4, 0.0, dx5, y0 - self.y, dx6, 0.0)
            st.clear()
        elif b1 == 36 and len(st) >= 9:  # hflex1
            dx1, dy1, dx2, dy2, dx3, dx4, dx5, dy5, dx6 = st[:9]
            y0 = self.y
            self._curveto(dx1, dy1, dx2, dy2, dx3, 0.0)
            # final endpoint returns to the starting y
            dy6 = y0 - (self.y + dy5)
            self._curveto(dx4, 0.0, dx5, dy5, dx6, dy6)
            st.clear()
        elif b1 == 37 and len(st) >= 11:  # flex1
            dx1, dy1, dx2, dy2, dx3, dy3, dx4, dy4, dx5, dy5, d6 = st[:11]
            x0, y0 = self.x, self.y
            dx = dx1 + dx2 + dx3 + dx4 + dx5
            dy = dy1 + dy2 + dy3 + dy4 + dy5
            self._curveto(dx1, dy1, dx2, dy2, dx3, dy3)
            if abs(dx) > abs(dy):
                dx6, dy6 = d6, y0 - (self.y + dy4 + dy5)
            else:
                dx6, dy6 = x0 - (self.x + dx4 + dx5), d6
            self._curveto(dx4, dy4, dx5, dy5, dx6, dy6)
            st.clear()
        elif b1 == 3 and len(st) >= 2:  # and
            b = st.pop()
            a = st.pop()
            st.append(1.0 if (a and b) else 0.0)
        elif b1 == 4 and len(st) >= 2:  # or
            b = st.pop()
            a = st.pop()
            st.append(1.0 if (a or b) else 0.0)
        elif b1 == 9 and st:  # abs
            st.append(abs(st.pop()))
        elif b1 == 10 and len(st) >= 2:  # add
            st.append(st.pop() + st.pop())
        elif b1 == 11 and len(st) >= 2:  # sub
            b = st.pop()
            st.append(st.pop() - b)
        elif b1 == 12 and len(st) >= 2:  # div
            b = st.pop()
            a = st.pop()
            st.append(a / b if b else 0.0)
        elif b1 == 14 and st:  # neg
            st.append(-st.pop())
        elif b1 == 18 and st:  # drop
            st.pop()
        elif b1 == 24 and len(st) >= 2:  # mul
            st.append(st.pop() * st.pop())
        elif b1 == 26 and st:  # sqrt
            st.append(abs(st.pop()) ** 0.5)
        elif b1 == 27 and st:  # dup
            st.append(st[-1])
        elif b1 == 28 and len(st) >= 2:  # exch
            st[-1], st[-2] = st[-2], st[-1]
        else:
            st.clear()  # unknown escape: drop args
        return i
