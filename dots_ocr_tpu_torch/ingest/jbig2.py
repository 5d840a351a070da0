"""JBIG2 arithmetic decoding (ITU-T T.88) for the builtin PDF backend.

Completes `minipdf._jbig2_decode` beyond the MMR profile:

- the MQ arithmetic decoder (T.88 Annex E, the same coder JPEG2000
  uses), with coder state separated from context sets so one decoder
  can drive many procedures within a segment;
- arithmetic GENERIC REGIONS (T.88 6.2.5: GB templates 0-3, nominal or
  custom AT pixels, TPGDON typical-prediction rows);
- arithmetic integer decoding (Annex A: the IADH/IADW/IAEX/... prefix
  code over a 512-context tree, and the IAID symbol-id tree);
- SYMBOL DICTIONARY segments (T.88 6.5, SDHUFF=0, SDREFAGG=0) and
  TEXT REGION segments (T.88 6.4, SBHUFF=0, REFINE=0: all reference
  corners, transposed placement, strip T offsets, S offsets, the four
  composition operators) — the profile PDF producers actually emit for
  scanned text.

Huffman-coded segments, refinement/aggregation, pattern/halftone
regions are NOT implemented: pages needing them must fall through to
the caller's no-image behavior rather than render wrong bits.

Context-bit ordering follows the interop-proven convention (template
pixels sorted by (y, x), MSB first) used by the open-source decoders
(pdf.js, jbig2dec).

The *encoders* in this module exist for round-trip testing only (no
PDF producer role): decoder correctness is gated by encode->decode
round-trips over random and structured inputs across templates,
reference corners, and strip configurations.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# T.88 Table E.1 — (Qe, NMPS, NLPS, SWITCH); shared with JPEG2000.
QE_TABLE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]


class MQContexts:
    """One adaptive context set (index + MPS per context id)."""

    __slots__ = ("icx", "mps")

    def __init__(self, num_contexts: int):
        self.icx = np.zeros(num_contexts, np.uint8)
        self.mps = np.zeros(num_contexts, np.uint8)


class MQDecoder:
    """T.88 Annex E software-conventions MQ decoder (state only; context
    sets are passed per call so one coder serves many procedures)."""

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        # INITDEC
        self.bp = 0
        b0 = data[0] if self.n else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self) -> None:
        data, bp, n = self.data, self.bp, self.n
        b = data[bp] if bp < n else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < n else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[self.bp] if self.bp < n else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, ctx: MQContexts, cx: int) -> int:
        icx = ctx.icx[cx]
        qe, nmps, nlps, switch = QE_TABLE[icx]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = int(ctx.mps[cx])
                ctx.icx[cx] = nmps
            else:
                d = 1 - int(ctx.mps[cx])
                if switch:
                    ctx.mps[cx] ^= 1
                ctx.icx[cx] = nlps
            self.a = qe
            # RENORMD
            while True:
                if self.ct == 0:
                    self._bytein()
                self.a = (self.a << 1) & 0xFFFF
                self.c = (self.c << 1) & 0xFFFFFFFF
                self.ct -= 1
                if self.a & 0x8000:
                    break
            return d
        self.c -= qe << 16
        if self.a & 0x8000:
            return int(ctx.mps[cx])
        # MPS exchange path
        if self.a < qe:
            d = 1 - int(ctx.mps[cx])
            if switch:
                ctx.mps[cx] ^= 1
            ctx.icx[cx] = nlps
        else:
            d = int(ctx.mps[cx])
            ctx.icx[cx] = nmps
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


class MQEncoder:
    """T.88 Annex E MQ encoder — TEST SUPPORT ONLY (round-trip gating)."""

    def __init__(self):
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.out: List[int] = []
        self.b = -1  # pending byte (B register); -1 = none yet

    def _byteout(self) -> None:
        # T.88 Figure E.8 exactly: C is only MASKED here — the left
        # shifts happen in the encode renorm loop.
        if self.b == 0xFF:
            self._stuff()
            return
        if self.c < 0x8000000:
            self._commit()
            self.b = (self.c >> 19) & 0xFF
            self.c &= 0x7FFFF
            self.ct = 8
            return
        self.b += 1  # carry (b was <= 0xFE here, no ripple possible)
        if self.b == 0xFF:
            self.c &= 0x7FFFFFF
            self._stuff()
        else:
            self._commit()
            self.b = (self.c >> 19) & 0xFF
            self.c &= 0x7FFFF
            self.ct = 8

    def _stuff(self) -> None:
        # After an 0xFF the next byte carries only 7 data bits; the carry
        # (bit 27) lands in the stuffed byte's MSB — do NOT mask it off.
        self._commit()
        self.b = (self.c >> 20) & 0xFF
        self.c &= 0xFFFFF
        self.ct = 7

    def _commit(self) -> None:
        if self.b >= 0:
            self.out.append(self.b)

    def encode(self, ctx: MQContexts, cx: int, d: int) -> None:
        # T.88 Figures E.3/E.4 (CODEMPS/CODELPS). Interval geometry matches
        # the decoder above: lower sub-interval [0,Qe) = LPS, upper = MPS,
        # exchanged when the MPS width A-Qe drops below Qe.
        icx = ctx.icx[cx]
        qe, nmps, nlps, switch = QE_TABLE[icx]
        self.a -= qe
        if d == ctx.mps[cx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe  # exchange: MPS takes the lower interval
            else:
                self.c += qe
            ctx.icx[cx] = nmps
        else:
            if self.a < qe:
                self.c += qe  # exchange: LPS takes the upper interval
            else:
                self.a = qe
            if switch:
                ctx.mps[cx] ^= 1
            ctx.icx[cx] = nlps
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self) -> bytes:
        # SETBITS
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self._commit()
        self.out.append(0xFF)
        self.out.append(0xAC)
        return bytes(self.out)


# Generic-region template pixel lists (dx, dy), BEFORE AT substitution.
# Ordering convention: sorted by (dy, dx), MSB first — matches pdf.js /
# jbig2dec context construction, which is the interop ground truth.
_FIXED = {
    0: [(-1, -2), (0, -2), (1, -2),
        (-2, -1), (-1, -1), (0, -1), (1, -1), (2, -1),
        (-4, 0), (-3, 0), (-2, 0), (-1, 0)],
    1: [(-1, -2), (0, -2), (1, -2), (2, -2),
        (-2, -1), (-1, -1), (0, -1), (1, -1), (2, -1),
        (-3, 0), (-2, 0), (-1, 0)],
    2: [(-1, -2), (0, -2), (1, -2),
        (-2, -1), (-1, -1), (0, -1), (1, -1),
        (-2, 0), (-1, 0)],
    3: [(-3, -1), (-2, -1), (-1, -1), (0, -1), (1, -1),
        (-4, 0), (-3, 0), (-2, 0), (-1, 0)],
}
NOMINAL_AT = {
    0: [(3, -1), (-3, -1), (2, -2), (-2, -2)],
    1: [(3, -1)],
    2: [(2, -1)],
    3: [(2, -1)],
}
# T.88 6.2.5.7 — SLTP decision contexts for TPGDON, per template.
_TPGDON_CONTEXT = {0: 0x9B25, 1: 0x0795, 2: 0x00E5, 3: 0x0195}


def _template(template: int, at: Optional[Sequence[Tuple[int, int]]]):
    pixels = list(_FIXED[template]) + list(at or NOMINAL_AT[template])
    pixels.sort(key=lambda p: (p[1], p[0]))
    return pixels


def decode_generic_region(
    data: bytes,
    width: int,
    height: int,
    template: int = 0,
    at: Optional[Sequence[Tuple[int, int]]] = None,
    tpgdon: bool = False,
    mq: Optional[MQDecoder] = None,
    gb: Optional[MQContexts] = None,
) -> np.ndarray:
    """Decode one arithmetic generic region -> bool[height, width]
    (True = black, the JBIG2 convention).

    `mq`/`gb` let a symbol dictionary share one coder + one GB context
    set across all its symbol bitmaps (T.88 6.5.8.1)."""
    pixels = _template(template, at)
    if mq is None and gb is None:
        # Standalone region (no shared coder state): the C++ fast path
        # decodes full-page regions ~2 orders of magnitude faster.
        from ..native import jbig2_generic_native

        out = jbig2_generic_native(
            data, width, height, pixels, tpgdon, _TPGDON_CONTEXT[template]
        )
        if out is not None:
            return out
    nbits = len(pixels)
    bitmap = np.zeros((height, width), np.uint8)
    dec = mq or MQDecoder(data)
    ctx = gb if gb is not None else MQContexts(1 << nbits)
    ltp = 0
    sltp_cx = _TPGDON_CONTEXT[template]
    for y in range(height):
        if tpgdon:
            if dec.decode(ctx, sltp_cx):
                ltp ^= 1
            if ltp:
                if y > 0:
                    bitmap[y] = bitmap[y - 1]
                continue
        row = bitmap[y]
        for x in range(width):
            cx = 0
            for dx, dy in pixels:
                xx, yy = x + dx, y + dy
                if 0 <= yy < height and 0 <= xx < width and yy <= y:
                    if yy == y and xx >= x:
                        bit = 0  # causality: only already-decoded pixels
                    else:
                        bit = int(bitmap[yy, xx])
                else:
                    bit = 0
                cx = (cx << 1) | bit
            row[x] = dec.decode(ctx, cx)
    return bitmap.astype(bool)


def encode_generic_region(
    bitmap: np.ndarray,
    template: int = 0,
    at: Optional[Sequence[Tuple[int, int]]] = None,
    tpgdon: bool = False,
    mq: Optional[MQEncoder] = None,
    gb: Optional[MQContexts] = None,
) -> Optional[bytes]:
    """TEST SUPPORT: arithmetic-encode a bitmap with the same context
    model the decoder uses (round-trip gating). With an external `mq`,
    bits are appended and no flush happens (returns None)."""
    bitmap = np.asarray(bitmap, np.uint8)
    height, width = bitmap.shape
    pixels = _template(template, at)
    enc = mq or MQEncoder()
    ctx = gb if gb is not None else MQContexts(1 << len(pixels))
    sltp_cx = _TPGDON_CONTEXT[template]
    ltp = 0
    for y in range(height):
        if tpgdon:
            same = y > 0 and bool(np.array_equal(bitmap[y], bitmap[y - 1]))
            sltp = 1 if same != bool(ltp) else 0
            enc.encode(ctx, sltp_cx, sltp)
            ltp ^= sltp
            if ltp:
                continue
        for x in range(width):
            cx = 0
            for dx, dy in pixels:
                xx, yy = x + dx, y + dy
                if 0 <= yy < height and 0 <= xx < width and (
                    yy < y or (yy == y and xx < x)
                ):
                    bit = int(bitmap[yy, xx])
                else:
                    bit = 0
                cx = (cx << 1) | bit
            enc.encode(ctx, cx, int(bitmap[y, x]))
    return None if mq is not None else enc.flush()


# ---------------------------------------------------------------------------
# Arithmetic integer decoding (T.88 Annex A) + symbol/text segments.
# ---------------------------------------------------------------------------

# (offset, suffix bits) per prefix class — A.2's IAx value tree. The class
# prefix is a unary run of 1s terminated by 0 (last class: five 1s).
_INT_CLASSES = [(0, 2), (4, 4), (20, 6), (84, 8), (340, 12), (4436, 32)]


class ArithIntDecoder:
    """One IAx procedure (IADH/IADW/IAEX/IAAI/IADT/IAFS/IADS/IAIT/IARI):
    a 512-context tree over the MQ coder. Returns int, or None for OOB."""

    def __init__(self) -> None:
        self.ctx = MQContexts(512)

    def decode(self, mq: MQDecoder) -> Optional[int]:
        ctx = self.ctx
        prev = 1

        def bit() -> int:
            nonlocal prev
            b = mq.decode(ctx, prev)
            if prev < 256:
                prev = (prev << 1) | b
            else:
                prev = ((((prev << 1) | b) & 511) | 256)
            return b

        sign = bit()
        for i, (offset, nbits) in enumerate(_INT_CLASSES):
            if i < len(_INT_CLASSES) - 1 and bit():
                continue
            val = 0
            for _ in range(nbits):
                val = (val << 1) | bit()
            val += offset
            if sign:
                return -val if val > 0 else None  # -0 encodes OOB
            return val
        raise AssertionError("unreachable")


class ArithIntEncoder:
    """TEST SUPPORT: mirror of :class:`ArithIntDecoder`."""

    def __init__(self) -> None:
        self.ctx = MQContexts(512)

    def encode(self, mq: MQEncoder, value: Optional[int]) -> None:
        ctx = self.ctx
        prev = 1

        def bit(b: int) -> None:
            nonlocal prev
            mq.encode(ctx, prev, b)
            if prev < 256:
                prev = (prev << 1) | b
            else:
                prev = ((((prev << 1) | b) & 511) | 256)

        if value is None:
            sign, mag = 1, 0  # OOB = negative zero
        elif value < 0:
            sign, mag = 1, -value
        else:
            sign, mag = 0, value
        bit(sign)
        for i, (offset, nbits) in enumerate(_INT_CLASSES):
            hi = offset + (1 << nbits) - 1
            last = i == len(_INT_CLASSES) - 1
            if mag <= hi:
                if not last:
                    bit(0)
                rem = mag - offset
                for j in range(nbits - 1, -1, -1):
                    bit((rem >> j) & 1)
                return
            bit(1)
        raise ValueError(f"integer {value} out of JBIG2 range")


class IAIDDecoder:
    """Symbol-id decoding (A.3): a full binary tree of SBSYMCODELEN bits."""

    def __init__(self, code_len: int) -> None:
        self.code_len = code_len
        self.ctx = MQContexts(1 << (code_len + 1))

    def decode(self, mq: MQDecoder) -> int:
        prev = 1
        for _ in range(self.code_len):
            prev = (prev << 1) | mq.decode(self.ctx, prev)
        return prev - (1 << self.code_len)


class IAIDEncoder:
    """TEST SUPPORT: mirror of :class:`IAIDDecoder`."""

    def __init__(self, code_len: int) -> None:
        self.code_len = code_len
        self.ctx = MQContexts(1 << (code_len + 1))

    def encode(self, mq: MQEncoder, sym_id: int) -> None:
        prev = 1
        for i in range(self.code_len - 1, -1, -1):
            b = (sym_id >> i) & 1
            mq.encode(self.ctx, prev, b)
            prev = (prev << 1) | b


def _sym_code_len(num_symbols: int) -> int:
    """SBSYMCODELEN = max(1, ceil(log2 n)) — the interop (pdf.js) reading
    of the T.88 errata for single-symbol dictionaries."""
    n = 0
    while (1 << n) < num_symbols:
        n += 1
    return max(n, 1)


_MAX_SYMBOL_PIXELS = 1 << 20  # glyphs are tiny; 1 Mpx/symbol is abuse
_MAX_DICT_PIXELS = 8_000_000  # cumulative across one dictionary
_MAX_REGION_PIXELS = 64_000_000


def decode_symbol_dictionary(
    payload: bytes, input_symbols: Sequence[np.ndarray]
) -> Optional[List[np.ndarray]]:
    """Decode a symbol dictionary segment (T.88 6.5, arithmetic profile:
    SDHUFF=0, SDREFAGG=0). Returns the exported symbol bitmaps in export
    order, or None if the segment needs unsupported machinery."""
    if len(payload) < 2:
        return None
    flags = int.from_bytes(payload[0:2], "big")
    sdhuff = flags & 1
    sdrefagg = (flags >> 1) & 1
    ctx_used = flags & 0x100
    ctx_retained = flags & 0x200
    template = (flags >> 10) & 3
    if sdhuff or sdrefagg or ctx_used or ctx_retained:
        return None
    pos = 2
    n_at = 4 if template == 0 else 1
    if len(payload) < pos + 2 * n_at + 8:
        return None
    at = [
        (
            int.from_bytes(payload[i : i + 1], "big", signed=True),
            int.from_bytes(payload[i + 1 : i + 2], "big", signed=True),
        )
        for i in range(pos, pos + 2 * n_at, 2)
    ]
    pos += 2 * n_at
    num_ex = int.from_bytes(payload[pos : pos + 4], "big")
    num_new = int.from_bytes(payload[pos + 4 : pos + 8], "big")
    pos += 8
    if num_new > 100_000 or num_ex > 100_000:
        return None
    from ..native import jbig2_symbol_dict_native

    native = jbig2_symbol_dict_native(
        payload[pos:], _template(template, at), num_new, len(input_symbols),
        max_pixels=_MAX_DICT_PIXELS,
    )
    if native is not None:
        dims, bits, export = native
        new_symbols = []
        used = 0
        for h, w in dims[:num_new]:
            new_symbols.append(
                bits[used : used + h * w].reshape(h, w).astype(bool)
            )
            used += h * w
        all_syms = list(input_symbols) + new_symbols
        return [s for s, f in zip(all_syms, export) if f]
    mq = MQDecoder(payload[pos:])
    iadh = ArithIntDecoder()
    iadw = ArithIntDecoder()
    iaex = ArithIntDecoder()
    gb = MQContexts(1 << 16)  # template 0 is the widest (16 context bits)
    new_symbols: List[np.ndarray] = []
    height = 0
    classes = 0
    total_pixels = 0
    while len(new_symbols) < num_new:
        classes += 1
        if classes > num_new + 64:
            return None  # hostile stream: classes yielding no symbols
        dh = iadh.decode(mq)
        if dh is None:
            return None
        height += dh
        width = 0
        while True:
            dw = iadw.decode(mq)
            if dw is None:
                break  # OOB ends this height class
            width += dw
            if (
                width <= 0
                or height <= 0
                or width * height > _MAX_SYMBOL_PIXELS
                or len(new_symbols) >= num_new
            ):
                return None
            total_pixels += width * height
            if total_pixels > _MAX_DICT_PIXELS:
                return None  # cumulative decode-work cap (DoS guard)
            new_symbols.append(
                decode_generic_region(
                    b"", width, height, template=template, at=at, mq=mq, gb=gb
                )
            )
    # Export flags: alternating runs (not-exported first) over
    # input symbols ++ new symbols.
    all_syms = list(input_symbols) + new_symbols
    export_flags: List[int] = []
    cur = 0
    runs = 0
    while len(export_flags) < len(all_syms):
        runs += 1
        if runs > 2 * len(all_syms) + 64:
            return None  # exhausted stream yielding zero-runs forever
        run = iaex.decode(mq)
        if run is None or run < 0:
            return None
        run = min(run, len(all_syms) - len(export_flags))  # clamp alloc
        export_flags.extend([cur] * run)
        cur ^= 1
    return [s for s, f in zip(all_syms, export_flags) if f]


def _compose(dst: np.ndarray, src: np.ndarray, x0: int, y0: int, op: int) -> bool:
    """Clip-composite src onto dst at (x0, y0) with a JBIG2 external
    combination operator (0 OR, 1 AND, 2 XOR, 3 XNOR, 4 REPLACE).
    Returns whether any pixels intersected."""
    H, W = dst.shape
    h, w = src.shape
    xa, ya = max(x0, 0), max(y0, 0)
    xb, yb = min(x0 + w, W), min(y0 + h, H)
    if xa >= xb or ya >= yb:
        return False
    sub = src[ya - y0 : yb - y0, xa - x0 : xb - x0]
    region = dst[ya:yb, xa:xb]
    if op == 0:
        region |= sub
    elif op == 1:
        region &= sub
    elif op == 2:
        region ^= sub
    elif op == 3:
        region[:] = ~(region ^ sub)
    else:
        region[:] = sub
    return True


def decode_text_region(
    payload: bytes, symbols: Sequence[np.ndarray]
) -> Optional[Tuple[np.ndarray, int, int, int]]:
    """Decode a text region segment (T.88 6.4, arithmetic profile:
    SBHUFF=0, REFINE=0). Returns (bitmap, x, y, external_comb_op) or
    None if the segment needs unsupported machinery."""
    if len(payload) < 23 or not symbols:
        return None
    rw = int.from_bytes(payload[0:4], "big")
    rh = int.from_bytes(payload[4:8], "big")
    rx = int.from_bytes(payload[8:12], "big")
    ry = int.from_bytes(payload[12:16], "big")
    ext_comb = payload[16] & 0x7
    flags = int.from_bytes(payload[17:19], "big")
    sbhuff = flags & 1
    refine = (flags >> 1) & 1
    strips = 1 << ((flags >> 2) & 3)
    ref_corner = (flags >> 4) & 3
    transposed = (flags >> 6) & 1
    sb_comb = (flags >> 7) & 3
    def_pixel = (flags >> 9) & 1
    ds_offset = (flags >> 10) & 0x1F
    if ds_offset > 15:
        ds_offset -= 32  # signed 5-bit field
    if sbhuff or refine:
        return None
    if rw * rh > _MAX_REGION_PIXELS:
        return None
    pos = 19
    num_instances = int.from_bytes(payload[pos : pos + 4], "big")
    pos += 4
    # Every instance costs bits on the wire; a count far beyond what the
    # payload could encode is a hostile header.
    if num_instances > 1_000_000 or num_instances > 64 * len(payload):
        return None
    code_len = _sym_code_len(len(symbols))
    mq = MQDecoder(payload[pos:])
    iadt = ArithIntDecoder()
    iafs = ArithIntDecoder()
    iads = ArithIntDecoder()
    iait = ArithIntDecoder()
    iaid = IAIDDecoder(code_len)

    bitmap = np.full((rh, rw), bool(def_pixel))
    dt0 = iadt.decode(mq)
    if dt0 is None:
        return None
    stript = -dt0  # in strip units
    firsts = 0
    inst = 0
    # Composition-work budget: legit text ink is O(region); an exhausted
    # stream re-stamping a large symbol per "instance" is not.
    compose_budget = 4 * rw * rh + 1_000_000
    while inst < num_instances:
        dt = iadt.decode(mq)
        if dt is None:
            return None
        stript += dt
        dfs = iafs.decode(mq)
        if dfs is None:
            return None
        firsts += dfs
        curs = firsts
        first = True
        while inst < num_instances:
            if not first:
                ids = iads.decode(mq)
                if ids is None:
                    break  # OOB ends this strip
                curs += ids + ds_offset
            first = False
            curt = 0
            if strips > 1:
                curt_v = iait.decode(mq)
                if curt_v is None:
                    return None
                curt = curt_v
            t = strips * stript + curt
            sym_id = iaid.decode(mq)
            if sym_id >= len(symbols):
                return None
            sym = symbols[sym_id]
            hi, wi = sym.shape
            compose_budget -= hi * wi
            if compose_budget < 0:
                return None
            # Reference corners: 0 BL, 1 TL, 2 BR, 3 TR. Along the S axis
            # the span is [curs, curs+adv] regardless of corner (T.88
            # 6.4.5 advances CURS before drawing for the far corners);
            # the T axis anchors top/left vs bottom/right.
            if transposed:
                x0 = t - (wi - 1 if ref_corner & 2 else 0)
                y0 = curs
                adv = hi - 1
            else:
                x0 = curs
                y0 = t - (0 if ref_corner & 1 else hi - 1)
                adv = wi - 1
            _compose(bitmap, sym, x0, y0, sb_comb)
            curs += adv
            inst += 1
        else:
            # instance budget reached mid-strip: consume the strip's
            # trailing OOB so well-formed streams end cleanly
            iads.decode(mq)
    return bitmap, rx, ry, ext_comb


def encode_symbol_dictionary(
    symbols: Sequence[np.ndarray], template: int = 0
) -> bytes:
    """TEST SUPPORT: build a symbol-dictionary segment payload exporting
    every symbol. Symbols must be grouped by non-decreasing is not
    required — consecutive equal heights form one height class."""
    mq = MQEncoder()
    iadh = ArithIntEncoder()
    iadw = ArithIntEncoder()
    iaex = ArithIntEncoder()
    gb = MQContexts(1 << 16)
    at = NOMINAL_AT[template]
    height = 0
    i = 0
    n = len(symbols)
    while i < n:
        h = symbols[i].shape[0]
        iadh.encode(mq, h - height)
        height = h
        width = 0
        while i < n and symbols[i].shape[0] == h:
            w = symbols[i].shape[1]
            iadw.encode(mq, w - width)
            width = w
            encode_generic_region(
                np.asarray(symbols[i], np.uint8), template=template,
                at=at, mq=mq, gb=gb,
            )
            i += 1
        iadw.encode(mq, None)  # OOB: height class done
    iaex.encode(mq, 0)  # run of not-exported
    iaex.encode(mq, n)  # run of exported: everything
    data = mq.flush()
    flags = (template & 3) << 10
    at_bytes = b"".join(bytes([dx & 0xFF, dy & 0xFF]) for dx, dy in at)
    return (
        flags.to_bytes(2, "big") + at_bytes
        + n.to_bytes(4, "big") + n.to_bytes(4, "big") + data
    )


def encode_text_region(
    rw: int,
    rh: int,
    rx: int,
    ry: int,
    ext_comb: int,
    symbols: Sequence[np.ndarray],
    instances: Sequence[Tuple[int, int, int]],
    strips: int = 1,
    ref_corner: int = 1,
    transposed: bool = False,
    ds_offset: int = 0,
    def_pixel: int = 0,
    sb_comb: int = 0,
) -> bytes:
    """TEST SUPPORT: build a text-region segment payload. `instances` is
    a list of (sym_id, s, t): s = the CURS value at draw time, t = the T
    coordinate in pixels; consecutive instances with the same strip
    (t // strips) share one strip record. Within a strip, s must be
    reachable (non-first instances encode ids = s - curs - ds_offset)."""
    log_strips = {1: 0, 2: 1, 4: 2, 8: 3}[strips]
    code_len = _sym_code_len(len(symbols))
    mq = MQEncoder()
    iadt = ArithIntEncoder()
    iafs = ArithIntEncoder()
    iads = ArithIntEncoder()
    iait = ArithIntEncoder()
    iaid = IAIDEncoder(code_len)
    iadt.encode(mq, 0)  # initial STRIPT = 0
    # group consecutive instances by strip unit
    groups: List[Tuple[int, List[Tuple[int, int, int]]]] = []
    for sym_id, s, t in instances:
        unit = t // strips
        if groups and groups[-1][0] == unit:
            groups[-1][1].append((sym_id, s, t))
        else:
            groups.append((unit, [(sym_id, s, t)]))
    prev_unit = 0
    firsts = 0
    for unit, group in groups:
        iadt.encode(mq, unit - prev_unit)
        prev_unit = unit
        iafs.encode(mq, group[0][1] - firsts)
        firsts = group[0][1]
        curs = firsts
        for j, (sym_id, s, t) in enumerate(group):
            if j > 0:
                iads.encode(mq, s - curs - ds_offset)
                curs = s
            curt = t - unit * strips
            if strips > 1:
                iait.encode(mq, curt)
            elif curt:
                raise ValueError("t not on strip grid")
            iaid.encode(mq, sym_id)
            hi, wi = symbols[sym_id].shape
            curs += (hi - 1) if transposed else (wi - 1)
        iads.encode(mq, None)  # OOB ends strip
    data = mq.flush()
    flags = (
        (log_strips << 2) | (ref_corner << 4) | (int(transposed) << 6)
        | (sb_comb << 7) | (def_pixel << 9) | ((ds_offset & 0x1F) << 10)
    )
    return (
        rw.to_bytes(4, "big") + rh.to_bytes(4, "big")
        + rx.to_bytes(4, "big") + ry.to_bytes(4, "big")
        + bytes([ext_comb]) + flags.to_bytes(2, "big")
        + len(instances).to_bytes(4, "big") + data
    )
