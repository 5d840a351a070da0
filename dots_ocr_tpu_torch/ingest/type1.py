"""Type 1 (`FontFile`) charstring rasterizer, glyph-NAME addressed.

Third outline front end beside ``ingest/ttf.py`` (TrueType quadratics)
and ``ingest/cff.py`` (Type 2 cubics): PDFs from pdfTeX/dvips pipelines
embed PostScript Type 1 programs (Computer Modern etc.) as `FontFile`
streams, and their built-in encodings (OT1 and friends) place glyphs at
codes PIL's unicode-addressed FreeType lookup garbles. This module
decrypts the eexec section, interprets Type 1 charstrings (flex and seac
included), and rasterizes through the same supersampled nonzero-winding
scanline fill (:func:`ttf.render_contours`) so the builtin PDF backend
addresses Type 1 glyphs by NAME through the PDF /Encoding Differences —
the correct addressing model for this font class.

Reference counterpart: MuPDF's font engine behind PyMuPDF
(``/root/reference/dots_ocr/utils/doc_utils.py:20-39``) — rebuilt from
the Adobe Type 1 spec (T1_SPEC, "Adobe Type 1 Font Format") rather than
ported. Hints are parsed and skipped (unhinted fill, same policy as the
TrueType/CFF sides); multiple-master and chameleon fonts are out of
scope.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from dots_ocr_tpu_torch.ingest.ttf import render_contours

_CURVE_STEPS = 8

# Adobe StandardEncoding glyph names for codes 32..126 (codepoint order).
_ASCII_NAMES = (
    "space exclam quotedbl numbersign dollar percent ampersand quoteright "
    "parenleft parenright asterisk plus comma hyphen period slash zero one "
    "two three four five six seven eight nine colon semicolon less equal "
    "greater question at A B C D E F G H I J K L M N O P Q R S T U V W X Y "
    "Z bracketleft backslash bracketright asciicircum underscore quoteleft "
    "a b c d e f g h i j k l m n o p q r s t u v w x y z braceleft bar "
    "braceright asciitilde"
).split()

STANDARD_ENCODING: Dict[int, str] = {
    code: name for code, name in enumerate(_ASCII_NAMES, start=32)
}
# The accent slots seac composes through (StandardEncoding upper range).
STANDARD_ENCODING.update({
    193: "grave", 194: "acute", 195: "circumflex", 196: "tilde",
    197: "macron", 198: "breve", 199: "dotaccent", 200: "dieresis",
    202: "ring", 203: "cedilla", 205: "hungarumlaut", 206: "ogonek",
    207: "caron",
})


def _decrypt(data: bytes, r: int, skip: int) -> bytes:
    """Adobe eexec/charstring decryption (T1 spec §7.2)."""
    out = bytearray(len(data))
    for i, c in enumerate(data):
        out[i] = c ^ (r >> 8)
        r = ((c + r) * 52845 + 22719) & 0xFFFF
    return bytes(out[skip:])


def _pfb_unwrap(data: bytes) -> bytes:
    """Concatenate PFB segment payloads (0x80-framed) into a flat stream."""
    out = bytearray()
    i = 0
    while i + 6 <= len(data) and data[i] == 0x80:
        seg_type = data[i + 1]
        if seg_type == 3:  # EOF
            break
        (length,) = struct.unpack("<I", data[i + 2 : i + 6])
        out += data[i + 6 : i + 6 + length]
        i += 6 + length
    return bytes(out) if out else data


class Type1Font:
    """Parsed Type 1 font program; renders glyphs by PostScript name.

    Exposes the same bitmap contract as ``ttf.TrueTypeFont.render_glyph``
    via :meth:`render_glyph_name`. ``encoding`` is the font's BUILT-IN
    encoding (code -> glyph name); the PDF /Encoding /Differences array
    overrides it per code at the caller (``minipdf.LoadedFont``).
    """

    units_per_em = 1000.0

    def __init__(self, data: bytes):
        data = _pfb_unwrap(bytes(data))
        idx = data.find(b"eexec")
        if idx < 0:
            raise ValueError("not a Type 1 font program (no eexec)")
        clear = data[:idx]
        enc = data[idx + 5 :].lstrip(b"\r\n\t ")
        # Hex (PFA) vs raw binary eexec section: hex if the first 4 bytes
        # are all hex digits (T1 spec §7.2 detection rule).
        if all(c in b"0123456789abcdefABCDEF" for c in enc[:4]):
            hex_digits = re.sub(rb"[^0-9a-fA-F]", b"", enc)
            if len(hex_digits) % 2:
                hex_digits = hex_digits[:-1]
            enc = bytes.fromhex(hex_digits.decode("ascii"))
        priv = _decrypt(enc, 55665, 4)

        m = re.search(rb"/lenIV\s+(\d+)", priv)
        len_iv = int(m.group(1)) if m else 4

        self.subrs: List[bytes] = []
        sub_m = re.search(rb"/Subrs\s+(\d+)", priv)
        if sub_m:
            self.subrs = [b""] * int(sub_m.group(1))
            for m in re.finditer(
                rb"dup\s+(\d+)\s+(\d+)\s+(?:RD|-\|)[ ]", priv
            ):
                i, ln = int(m.group(1)), int(m.group(2))
                if 0 <= i < len(self.subrs):
                    self.subrs[i] = _decrypt(
                        priv[m.end() : m.end() + ln], 4330, len_iv
                    )

        self.charstrings: Dict[str, bytes] = {}
        cs_at = priv.find(b"/CharStrings")
        if cs_at >= 0:
            for m in re.finditer(
                rb"/([^\s/{}()\[\]<>]+)\s+(\d+)\s+(?:RD|-\|)[ ]",
                priv[cs_at:],
            ):
                ln = int(m.group(2))
                start = cs_at + m.end()
                self.charstrings[m.group(1).decode("latin-1")] = _decrypt(
                    priv[start : start + ln], 4330, len_iv
                )
        if not self.charstrings:
            raise ValueError("no Type 1 charstrings found")

        self.encoding: Dict[int, str] = {}
        if re.search(rb"/Encoding\s+StandardEncoding\s+def", clear):
            self.encoding = dict(STANDARD_ENCODING)
        else:
            for m in re.finditer(
                rb"dup\s+(\d+)\s*/([^\s/{}()\[\]<>]+)\s+put", clear
            ):
                self.encoding[int(m.group(1))] = m.group(2).decode("latin-1")

        self._contour_cache: Dict[str, List[np.ndarray]] = {}

    # -- outlines -------------------------------------------------------

    def _contours(self, name: str, depth: int = 0) -> List[np.ndarray]:
        if name in self._contour_cache:
            return self._contour_cache[name]
        code = self.charstrings.get(name)
        if code is None or depth > 2:
            return []
        interp = _Type1Interp(code, self.subrs)
        try:
            contours = interp.run()
        except Exception:
            contours = []
        if interp.seac is not None and depth <= 2:
            asb, adx, ady, bchar, achar = interp.seac
            contours = list(contours)
            # Accent displacement per T1 spec §8.6 / FreeType t1_ops:
            # adx - asb plus the seac char's own left sidebearing.
            acc_dx = adx - asb + interp.sbx
            for ch, dx, dy in ((bchar, 0.0, 0.0), (achar, acc_dx, ady)):
                sub = STANDARD_ENCODING.get(int(ch))
                if sub:
                    for c in self._contours(sub, depth + 1):
                        contours.append([(x + dx, y + dy) for x, y in c])
        out = [np.asarray(c, np.float64) for c in contours if len(c) >= 3]
        self._contour_cache[name] = out
        return out

    def render_glyph_name(
        self, name: str, px: float
    ) -> Tuple[Optional[np.ndarray], float, float]:
        """Rasterize glyph ``name``; same contract as
        ``ttf.TrueTypeFont.render_glyph``."""
        contours = self._contours(name)
        if not contours:
            return None, 0.0, 0.0
        return render_contours(contours, self.units_per_em, px)


class _Type1Interp:
    """One-shot Type 1 charstring executor -> flattened contours."""

    def __init__(self, code: bytes, subrs: List[bytes]):
        self.code = code
        self.subrs = subrs
        self.stack: List[float] = []
        self.ps_stack: List[float] = []  # othersubr results for `pop`
        self.x = 0.0
        self.y = 0.0
        self.sbx = 0.0
        self.contours: List[List[Tuple[float, float]]] = []
        self.current: List[Tuple[float, float]] = []
        self.finished = False
        self.seac: Optional[Tuple[float, float, float, int, int]] = None
        self.flex_pts: Optional[List[Tuple[float, float]]] = None

    def _moveto(self, dx: float, dy: float) -> None:
        self.x += dx
        self.y += dy
        if self.flex_pts is not None:
            self.flex_pts.append((self.x, self.y))
            return
        if len(self.current) >= 3:
            self.contours.append(self.current)
        self.current = [(self.x, self.y)]

    def _lineto(self, dx: float, dy: float) -> None:
        self.x += dx
        self.y += dy
        self.current.append((self.x, self.y))

    def _curve_abs(self, x1, y1, x2, y2, x3, y3) -> None:
        x0, y0 = self.x, self.y
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

    def _curveto(self, dx1, dy1, dx2, dy2, dx3, dy3) -> None:
        x1, y1 = self.x + dx1, self.y + dy1
        x2, y2 = x1 + dx2, y1 + dy2
        self._curve_abs(x1, y1, x2, y2, x2 + dx3, y2 + dy3)

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
            if b0 >= 32:
                if b0 <= 246:
                    st.append(b0 - 139)
                    i += 1
                elif b0 <= 250:
                    st.append((b0 - 247) * 256 + code[i + 1] + 108)
                    i += 2
                elif b0 <= 254:
                    st.append(-(b0 - 251) * 256 - code[i + 1] - 108)
                    i += 2
                else:  # 255: 32-bit signed int (T1, unlike Type 2's 16.16)
                    st.append(
                        float(struct.unpack(">i", code[i + 1 : i + 5])[0])
                    )
                    i += 5
                continue
            i += 1
            if b0 in (1, 3):  # hstem / vstem — unhinted
                del st[:]
            elif b0 == 4 and st:  # vmoveto
                self._moveto(0.0, st[-1])
                del st[:]
            elif b0 == 5 and len(st) >= 2:  # rlineto
                self._lineto(st[-2], st[-1])
                del st[:]
            elif b0 == 6 and st:  # hlineto (single arg in Type 1)
                self._lineto(st[-1], 0.0)
                del st[:]
            elif b0 == 7 and st:  # vlineto
                self._lineto(0.0, st[-1])
                del st[:]
            elif b0 == 8 and len(st) >= 6:  # rrcurveto
                self._curveto(*st[-6:])
                del st[:]
            elif b0 == 9:  # closepath
                if len(self.current) >= 3:
                    self.contours.append(self.current)
                self.current = []
                del st[:]
            elif b0 == 10 and st:  # callsubr (no bias in Type 1)
                idx = int(st.pop())
                if 0 <= idx < len(self.subrs):
                    self._exec(self.subrs[idx], depth + 1)
            elif b0 == 11:  # return
                return
            elif b0 == 13 and len(st) >= 2:  # hsbw: sbx wx
                self.sbx = st[-2]
                self.x = st[-2]
                self.y = 0.0
                del st[:]
            elif b0 == 14:  # endchar
                self.finished = True
            elif b0 == 21 and len(st) >= 2:  # rmoveto
                self._moveto(st[-2], st[-1])
                del st[:]
            elif b0 == 22 and st:  # hmoveto
                self._moveto(st[-1], 0.0)
                del st[:]
            elif b0 == 30 and len(st) >= 4:  # vhcurveto
                self._curveto(0.0, st[-4], st[-3], st[-2], st[-1], 0.0)
                del st[:]
            elif b0 == 31 and len(st) >= 4:  # hvcurveto
                self._curveto(st[-4], 0.0, st[-3], st[-2], 0.0, st[-1])
                del st[:]
            elif b0 == 12:
                b1 = code[i]
                i += 1
                if b1 in (0, 1, 2):  # dotsection / vstem3 / hstem3
                    del st[:]
                elif b1 == 6 and len(st) >= 5:  # seac
                    self.seac = (
                        st[-5], st[-4], st[-3], int(st[-2]), int(st[-1])
                    )
                    self.finished = True
                elif b1 == 7 and len(st) >= 4:  # sbw: sbx sby wx wy
                    self.sbx = st[-4]
                    self.x, self.y = st[-4], st[-3]
                    del st[:]
                elif b1 == 12 and len(st) >= 2:  # div
                    b = st.pop()
                    a = st.pop()
                    st.append(a / b if b else 0.0)
                elif b1 == 16 and len(st) >= 2:  # callothersubr
                    oth = int(st.pop())
                    nargs = int(st.pop())
                    args = st[-nargs:] if nargs else []
                    del st[len(st) - nargs :]
                    self._othersubr(oth, args)
                elif b1 == 17:  # pop <- othersubr result
                    st.append(self.ps_stack.pop() if self.ps_stack else 0.0)
                elif b1 == 33 and len(st) >= 2:  # setcurrentpoint
                    self.x, self.y = st[-2], st[-1]
                    del st[:]
                else:
                    del st[:]
            else:
                del st[:]

    def _othersubr(self, oth: int, args: List[float]) -> None:
        """T1 spec §8.3: flex (othersubrs 0-2) and hint replacement (3)
        are realized through the PostScript interpreter; emulate the
        documented protocol."""
        if oth == 1:  # flex start: subsequent rmoveto's collect points
            self.flex_pts = []
        elif oth == 2:  # one flex point collected (by _moveto)
            pass
        elif oth == 0:  # flex end: 7 collected points -> two curves
            pts = self.flex_pts or []
            self.flex_pts = None
            if len(pts) >= 7:
                # pts[0] is the flex reference point; 1-6 are controls.
                self._curve_abs(*pts[1], *pts[2], *pts[3])
                self._curve_abs(*pts[4], *pts[5], *pts[6])
            # `pop pop setcurrentpoint` follows: first pop must yield x.
            self.ps_stack = [self.y, self.x]
        elif oth == 3:  # hint replacement: `pop` fetches the subr number
            self.ps_stack = list(args) or [3.0]
        else:  # unknown othersubr: leave args for pops
            self.ps_stack = list(args)
