"""minipdf: self-contained pure-Python PDF parser + page rasterizer.

The reference delegates PDF rasterization to PyMuPDF/MuPDF (C), see
``dots_ocr/utils/doc_utils.py:20-59``. This environment has no PDF native
library, so the rebuild ships its own ingestion subsystem with a pluggable
backend registry (``dots_ocr_tpu_torch/ingest/pdf.py``); this module is the
built-in fallback backend.

Scope (an OCR front end, not a full viewer):
  * object model: full PDF object syntax, streams, object streams (ObjStm);
    robust object discovery by linear scan (works with broken xref tables,
    which also sidesteps xref-stream parsing),
  * encryption: standard security handler (RC4-128 / AES-128 / AES-256)
    with the EMPTY user password — the permissions-only class PyMuPDF
    opens silently; real passwords raise;
  * filters: FlateDecode (incl. PNG predictors), DCTDecode, ASCIIHexDecode,
    ASCII85Decode, RunLengthDecode, LZWDecode (incl. predictors),
    CCITTFaxDecode (Group 3/4 fax — the scanned-document encoding — via
    TIFF framing + PIL/libtiff),
  * rasterization: image XObjects (the scanned-document case) composited
    under the full affine CTM; Form XObjects (recursive); vector paths
    (m/l/c/v/y/h/re with fills and CTM-scaled strokes, Beziers flattened);
    text rendering: embedded TrueType and CFF/Type2 glyph programs are
    rasterized BY GLYPH ID (ingest/ttf.py, ingest/cff.py) for composite
    fonts, positioned by the PDF text matrix and advanced by font widths
    (/Widths for simple fonts, /W + /DW for CID fonts); simple 1-byte fonts
    go through PIL's FreeType binding with ToUnicode/latin-1 mapping.

Fidelity notes: clipping paths (W/W*) intersect device-space coverage
masks (both winding rules approximated by the painter's per-subpath
scanline fill); compound even-odd holes fill per-subpath; axial/radial
shadings paint via `sh` and PatternType 2 fills (function types 0/2/3);
tiling patterns repeat their cell (general affine matrices); mesh
shadings (4/5) Gouraud-rasterize, Coons/tensor patches (6/7) approximate
by corner triangles. For document
OCR (text + images on a white page) this reproduces what the model needs
to see.
"""

from __future__ import annotations

import io
import math
import re
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from PIL import Image, ImageChops, ImageDraw, ImageFont

# ---------------------------------------------------------------------------
# Object model
# ---------------------------------------------------------------------------


class Name(str):
    """A PDF name (/Foo). Subclass of str so it hashes/compares naturally."""

    __slots__ = ()


@dataclass(frozen=True)
class Ref:
    num: int
    gen: int


@dataclass
class StreamObj:
    dict: Dict[Name, Any]
    raw: bytes

    def decoded(self, doc: "PDFDocument") -> bytes:
        return apply_filters(self.dict, self.raw, doc)


_WHITESPACE = b"\x00\t\n\x0c\r "
_DELIMS = b"()<>[]{}/%"


class Lexer:
    """Tokenizer/parser over a bytes buffer at a movable position."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _skip_ws(self) -> None:
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            if c in _WHITESPACE:
                self.pos += 1
            elif c == 0x25:  # '%' comment to EOL
                while self.pos < n and data[self.pos] not in b"\r\n":
                    self.pos += 1
            else:
                break

    def peek_keyword(self) -> Optional[bytes]:
        self._skip_ws()
        m = re.match(rb"[A-Za-z'\"*]+", self.data[self.pos : self.pos + 32])
        return m.group() if m else None

    def parse_value(self) -> Any:
        self._skip_ws()
        data, pos = self.data, self.pos
        if pos >= len(data):
            raise EOFError("unexpected end of PDF data")
        c = data[pos : pos + 1]

        if c == b"<":
            if data[pos : pos + 2] == b"<<":
                return self._parse_dict_or_stream()
            return self._parse_hex_string()
        if c == b"(":
            return self._parse_literal_string()
        if c == b"/":
            return self._parse_name()
        if c == b"[":
            return self._parse_array()
        if c in b"+-.0123456789":
            return self._parse_number_or_ref()
        kw = self.peek_keyword()
        if kw is not None:
            if kw.startswith(b"true"):
                self.pos += 4
                return True
            if kw.startswith(b"false"):
                self.pos += 5
                return False
            if kw.startswith(b"null"):
                self.pos += 4
                return None
        raise ValueError(f"cannot parse PDF value at offset {pos}: {data[pos:pos+20]!r}")

    def _parse_name(self) -> Name:
        assert self.data[self.pos : self.pos + 1] == b"/"
        self.pos += 1
        start = self.pos
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            if c in _WHITESPACE or c in _DELIMS:
                break
            self.pos += 1
        raw = data[start : self.pos]
        # #xx hex escapes
        if b"#" in raw:
            out = bytearray()
            i = 0
            while i < len(raw):
                if raw[i : i + 1] == b"#" and i + 2 < len(raw) + 1:
                    try:
                        out.append(int(raw[i + 1 : i + 3], 16))
                        i += 3
                        continue
                    except ValueError:
                        pass
                out.append(raw[i])
                i += 1
            raw = bytes(out)
        return Name(raw.decode("latin-1"))

    def _parse_number_or_ref(self) -> Any:
        m = re.match(rb"[+-]?(?:\d+\.\d*|\.\d+|\d+)", self.data[self.pos :])
        tok = m.group()
        self.pos += len(tok)
        if b"." in tok:
            return float(tok)
        value = int(tok)
        # Lookahead for "gen R" making this an indirect reference.
        save = self.pos
        self._skip_ws()
        m2 = re.match(rb"(\d+)\s+R(?![A-Za-z])", self.data[self.pos : self.pos + 24])
        if value >= 0 and m2:
            self.pos += m2.end()
            return Ref(value, int(m2.group(1)))
        self.pos = save
        return value

    def _parse_array(self) -> list:
        self.pos += 1  # '['
        out = []
        while True:
            self._skip_ws()
            if self.data[self.pos : self.pos + 1] == b"]":
                self.pos += 1
                return out
            out.append(self.parse_value())

    def _parse_hex_string(self) -> bytes:
        self.pos += 1  # '<'
        end = self.data.index(b">", self.pos)
        hexdata = re.sub(rb"\s", b"", self.data[self.pos : end])
        self.pos = end + 1
        if len(hexdata) % 2:
            hexdata += b"0"
        return bytes.fromhex(hexdata.decode("ascii"))

    def _parse_literal_string(self) -> bytes:
        self.pos += 1  # '('
        out = bytearray()
        depth = 1
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            if c == 0x5C:  # backslash
                self.pos += 1
                if self.pos >= n:
                    break
                e = data[self.pos]
                esc = {0x6E: b"\n", 0x72: b"\r", 0x74: b"\t", 0x62: b"\b", 0x66: b"\f"}
                if e in esc:
                    out += esc[e]
                    self.pos += 1
                elif e in b"01234567":
                    oct_digits = bytearray()
                    while len(oct_digits) < 3 and self.pos < n and data[self.pos] in b"01234567":
                        oct_digits.append(data[self.pos])
                        self.pos += 1
                    out.append(int(oct_digits, 8) & 0xFF)
                elif e in b"\r\n":  # line continuation
                    self.pos += 1
                    if e == 0x0D and self.pos < n and data[self.pos] == 0x0A:
                        self.pos += 1
                else:
                    out.append(e)
                    self.pos += 1
            elif c == 0x28:  # '('
                depth += 1
                out.append(c)
                self.pos += 1
            elif c == 0x29:  # ')'
                depth -= 1
                self.pos += 1
                if depth == 0:
                    return bytes(out)
                out.append(c)
            else:
                out.append(c)
                self.pos += 1
        return bytes(out)

    def _parse_dict_or_stream(self) -> Any:
        self.pos += 2  # '<<'
        d: Dict[Name, Any] = {}
        while True:
            self._skip_ws()
            if self.data[self.pos : self.pos + 2] == b">>":
                self.pos += 2
                break
            key = self._parse_name()
            d[key] = self.parse_value()
        # stream?
        save = self.pos
        self._skip_ws()
        if self.data[self.pos : self.pos + 6] == b"stream":
            self.pos += 6
            if self.data[self.pos : self.pos + 2] == b"\r\n":
                self.pos += 2
            elif self.data[self.pos : self.pos + 1] in (b"\n", b"\r"):
                self.pos += 1
            return ("__stream__", d, self.pos)  # resolved by caller (needs /Length)
        self.pos = save
        return d


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------


def _png_unpredict(data: bytes, predictor: int, columns: int, colors: int, bpc: int) -> bytes:
    # Native fast path (C++, see dots_ocr_tpu_torch/native) — byte-serial filters
    # are the slowest pure-Python part of decoding Flate page images.
    from dots_ocr_tpu_torch.native import png_unpredict_native

    native = png_unpredict_native(data, predictor, columns, colors, bpc)
    if native is not None:
        return native
    if predictor < 10:
        # TIFF predictor 2: horizontal differencing.
        if predictor == 2 and bpc == 8:
            row_len = columns * colors
            out = bytearray(data)
            for r in range(0, len(out) - row_len + 1, row_len):
                for i in range(colors, row_len):
                    out[r + i] = (out[r + i] + out[r + i - colors]) & 0xFF
            return bytes(out)
        return data
    bpp = max(1, (colors * bpc) // 8)
    row_len = (columns * colors * bpc + 7) // 8
    out = bytearray()
    prev = bytearray(row_len)
    pos = 0
    while pos + 1 + row_len <= len(data) + row_len and pos < len(data):
        ft = data[pos]
        pos += 1
        row = bytearray(data[pos : pos + row_len])
        pos += len(row)
        if len(row) < row_len:
            row += bytearray(row_len - len(row))
        if ft == 1:  # Sub
            for i in range(bpp, row_len):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ft == 2:  # Up
            for i in range(row_len):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 3:  # Average
            for i in range(row_len):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(row_len):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        out += row
        prev = row
    return bytes(out)


def _flate_decode(data: bytes, parms: Optional[dict]) -> bytes:
    try:
        raw = zlib.decompress(data)
    except zlib.error:
        try:
            raw = zlib.decompressobj().decompress(data)
        except zlib.error:
            raw = zlib.decompressobj(-15).decompress(data)
    if parms:
        predictor = int(parms.get("Predictor", 1) or 1)
        if predictor > 1:
            raw = _png_unpredict(
                raw,
                predictor,
                int(parms.get("Columns", 1) or 1),
                int(parms.get("Colors", 1) or 1),
                int(parms.get("BitsPerComponent", 8) or 8),
            )
    return raw


def _lzw_decode(data: bytes, parms: Optional[dict]) -> bytes:
    """LZWDecode (PDF 1.7 §7.4.4 / TIFF LZW): variable-width codes 9-12
    bits MSB-first, 256 = clear, 257 = EOD; EarlyChange (default 1) bumps
    the code width one code early. Dominant in 1990s-2000s PDFs."""
    early = 1
    if parms:
        early = int(parms.get("EarlyChange", 1) or 0)
    from dots_ocr_tpu_torch.native import lzw_decode_native

    native = lzw_decode_native(data, early)
    if native is not None:
        return bytes(_maybe_unpredict(native, parms))
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width = 9
    prev: Optional[bytes] = None
    acc = nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == 256:
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                width = 9
                prev = None
                continue
            if code == 257:
                return bytes(_maybe_unpredict(out, parms))
            if prev is None:
                if code >= 256:
                    break  # corrupt stream: first code must be literal
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                if len(table) < 4096:
                    table.append(prev + entry[:1])
            elif code == len(table) and len(table) < 4096:
                entry = prev + prev[:1]
                table.append(entry)
            else:
                break  # corrupt stream: out-of-range code
            out += entry
            prev = entry
            # TIFF/PDF EarlyChange: the width grows when the NEXT code to
            # assign (len(table)) reaches 2^w - EarlyChange — one code
            # EARLY at the default (verified round-trip vs libtiff; the
            # off-by-one desyncs at the first 9->10-bit boundary).
            if len(table) + early >= (1 << width) and width < 12:
                width += 1
    return bytes(_maybe_unpredict(out, parms))


def _maybe_unpredict(raw: bytes, parms: Optional[dict]) -> bytes:
    if parms:
        predictor = int(parms.get("Predictor", 1) or 1)
        if predictor > 1:
            return _png_unpredict(
                raw,
                predictor,
                int(parms.get("Columns", 1) or 1),
                int(parms.get("Colors", 1) or 1),
                int(parms.get("BitsPerComponent", 8) or 8),
            )
    return raw


def _ascii_hex_decode(data: bytes) -> bytes:
    data = data.split(b">")[0]
    data = re.sub(rb"\s", b"", data)
    if len(data) % 2:
        data += b"0"
    return bytes.fromhex(data.decode("ascii"))


def _ascii85_decode(data: bytes) -> bytes:
    import base64

    data = data.split(b"~>")[0]
    data = re.sub(rb"\s", b"", data)
    return base64.a85decode(data)


def _runlength_decode(data: bytes) -> bytes:
    from dots_ocr_tpu_torch.native import runlength_decode_native

    native = runlength_decode_native(data)
    if native is not None:
        return native
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n == 128:
            break
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        else:
            out += data[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


# Image filters that are handed to PIL as encoded payloads rather than decoded.
IMAGE_CODEC_FILTERS = {
    "DCTDecode", "DCT", "JPXDecode", "CCITTFaxDecode", "CCF", "JBIG2Decode",
}


def apply_filters(sdict: Dict[Name, Any], data: bytes, doc: "PDFDocument") -> bytes:
    """Apply the non-image filter chain of a stream. Image codec filters are
    left in place (the image decoder hands them to PIL)."""
    filters = doc.resolve(sdict.get("Filter"))
    parms = doc.resolve(sdict.get("DecodeParms")) or doc.resolve(sdict.get("DP"))
    if filters is None:
        return data
    if not isinstance(filters, list):
        filters = [filters]
    if not isinstance(parms, list):
        parms = [parms] * len(filters)
    for f, p in zip(filters, parms):
        f = str(doc.resolve(f))
        p = doc.resolve(p)
        if f in ("FlateDecode", "Fl"):
            data = _flate_decode(data, p)
        elif f in ("ASCIIHexDecode", "AHx"):
            data = _ascii_hex_decode(data)
        elif f in ("ASCII85Decode", "A85"):
            data = _ascii85_decode(data)
        elif f in ("RunLengthDecode", "RL"):
            data = _runlength_decode(data)
        elif f in ("LZWDecode", "LZW"):
            data = _lzw_decode(data, p if isinstance(p, dict) else None)
        elif f in IMAGE_CODEC_FILTERS:
            return data  # terminal: PIL decodes the codec payload
        else:
            raise NotImplementedError(f"PDF filter {f} not supported")
    return data


# ---------------------------------------------------------------------------
# Document
# ---------------------------------------------------------------------------

_OBJ_HEADER_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


_PW_PAD = bytes([
    0x28, 0xBF, 0x4E, 0x5E, 0x4E, 0x75, 0x8A, 0x41, 0x64, 0x00, 0x4E, 0x56,
    0xFF, 0xFA, 0x01, 0x08, 0x2E, 0x2E, 0x00, 0xB6, 0xD0, 0x68, 0x3E, 0x80,
    0x2F, 0x0C, 0xA9, 0xFE, 0x64, 0x53, 0x69, 0x7A,
])


def _rc4(key: bytes, data: bytes) -> bytes:
    from dots_ocr_tpu_torch.native import rc4_native

    native = rc4_native(key, data)
    if native is not None:
        return native
    s = list(range(256))
    j = 0
    for i in range(256):
        j = (j + s[i] + key[i % len(key)]) & 0xFF
        s[i], s[j] = s[j], s[i]
    out = bytearray(len(data))
    i = j = 0
    for n, c in enumerate(data):
        i = (i + 1) & 0xFF
        j = (j + s[i]) & 0xFF
        s[i], s[j] = s[j], s[i]
        out[n] = c ^ s[(s[i] + s[j]) & 0xFF]
    return bytes(out)


def _aes_cbc_decrypt(key: bytes, data: bytes) -> bytes:
    """AES-CBC with the 16-byte IV prefixed to the payload (PDF §7.6.2)."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    if len(data) < 16:
        return b""
    body = data[16:]
    body = body[: len(body) - len(body) % 16]
    if not body:
        return b""
    dec = Cipher(algorithms.AES(key), modes.CBC(data[:16])).decryptor()
    out = dec.update(body) + dec.finalize()
    pad = out[-1] if out else 0
    if 1 <= pad <= 16:  # strip PKCS#7
        out = out[:-pad]
    return out


class _StdCrypt:
    """PDF standard security handler, EMPTY-user-password open only
    (the common permissions-only encryption PyMuPDF opens silently).
    R2-R4: RC4 / AES-128 with per-object keys; R6: AES-256 (ISO 32000-2
    algorithm 2.A/2.B). Raises ValueError when a real password is needed
    (callers surface "password required")."""

    def __init__(self, enc: Dict[Name, Any], file_id: bytes, resolve):
        import hashlib

        self.v = int(resolve(enc.get("V")) or 0)
        self.r = int(resolve(enc.get("R")) or 2)
        o = resolve(enc.get("O"))
        u = resolve(enc.get("U"))
        self.o = bytes(o or b"")
        self.u = bytes(u or b"")
        p = int(resolve(enc.get("P")) or -1)
        self.p = p & 0xFFFFFFFF
        length = int(resolve(enc.get("Length")) or 40)
        self.aes = False
        # V>=4 names per-class crypt filters; /Identity means "not
        # encrypted" for that class (legal strings-only configs exist).
        self.encrypt_streams = True
        self.encrypt_strings = True
        if self.v >= 4:
            cf = resolve(enc.get("CF")) or {}
            stmf = resolve(enc.get("StmF")) or Name("Identity")
            strf = resolve(enc.get("StrF")) or Name("Identity")
            self.encrypt_streams = stmf != Name("Identity")
            self.encrypt_strings = strf != Name("Identity")
            std = resolve(cf.get(stmf if self.encrypt_streams else strf)) \
                if isinstance(cf, dict) else None
            cfm = resolve(std.get("CFM")) if isinstance(std, dict) else None
            self.aes = cfm in (Name("AESV2"), Name("AESV3"))
            if isinstance(std, dict) and std.get("Length"):
                cfl = int(resolve(std.get("Length")))
                length = cfl * 8 if cfl <= 32 else cfl
        if self.r >= 5:
            # AES-256: validate the empty user password and unwrap /UE.
            vs, ks = self.u[32:40], self.u[40:48]
            if self._hash_r6(b"", vs, b"") != self.u[:32]:
                raise ValueError("PDF requires a user password")
            ikey = self._hash_r6(b"", ks, b"")
            ue = bytes(resolve(enc.get("UE")) or b"")
            from cryptography.hazmat.primitives.ciphers import (
                Cipher, algorithms, modes,
            )
            dec = Cipher(
                algorithms.AES(ikey), modes.CBC(b"\x00" * 16)
            ).decryptor()
            self.key = dec.update(ue[:32]) + dec.finalize()
            self.aes = True
            return
        n = max(5, min(16, length // 8))
        md = hashlib.md5()
        md.update(_PW_PAD)
        md.update(self.o[:32])
        md.update(self.p.to_bytes(4, "little"))
        md.update(file_id)
        if self.r >= 4 and resolve(enc.get("EncryptMetadata")) is False:
            md.update(b"\xff\xff\xff\xff")
        key = md.digest()
        if self.r >= 3:
            for _ in range(50):
                key = hashlib.md5(key[:n]).digest()
        self.key = key[:n]
        # Algorithm 6: verify the EMPTY user password against /U — a
        # wrong key must fail loudly, not silently decrypt to garbage.
        if self.r == 2:
            expect = _rc4(self.key, _PW_PAD)
            ok = expect == self.u[:32]
        else:
            h = hashlib.md5(_PW_PAD + file_id).digest()
            for i in range(20):
                h = _rc4(bytes(b ^ i for b in self.key), h)
            ok = h == self.u[:16]
        if not ok:
            raise ValueError("PDF requires a user password")

    def _hash_r6(self, pw: bytes, salt: bytes, udata: bytes) -> bytes:
        """ISO 32000-2 algorithm 2.B (R6 hardened hash)."""
        import hashlib

        from cryptography.hazmat.primitives.ciphers import (
            Cipher, algorithms, modes,
        )

        k = hashlib.sha256(pw + salt + udata).digest()
        if self.r < 6:
            return k
        i = 0
        while True:
            k1 = (pw + k + udata) * 64
            enc = Cipher(
                algorithms.AES(k[:16]), modes.CBC(k[16:32])
            ).encryptor()
            e = enc.update(k1) + enc.finalize()
            # ISO 32000-2 2.B: the first 16 bytes of E as a big-endian
            # integer mod 3 (== sum of those bytes mod 3, as pdf.js /
            # mupdf implement) — NOT e[0] % 3.
            mod = sum(e[:16]) % 3
            k = (
                hashlib.sha256(e).digest() if mod == 0
                else hashlib.sha384(e).digest() if mod == 1
                else hashlib.sha512(e).digest()
            )
            i += 1
            if i >= 64 and e[-1] <= i - 32:
                return k[:32]

    def decrypt(self, data: bytes, num: int, gen: int) -> bytes:
        import hashlib

        if self.r >= 5:
            return _aes_cbc_decrypt(self.key, data)
        ok = (
            self.key + num.to_bytes(3, "little") + gen.to_bytes(2, "little")
        )
        if self.aes:
            ok += b"\x73\x41\x6c\x54"  # "sAlT"
        okey = hashlib.md5(ok).digest()[: min(len(self.key) + 5, 16)]
        if self.aes:
            return _aes_cbc_decrypt(okey, data)
        return _rc4(okey, data)


class PDFDocument:
    """Parsed PDF: object map + page list.

    Object discovery is a linear scan over ``N G obj`` headers (robust to
    damaged xref tables; object streams are expanded afterwards). Matches
    that fall inside a previously parsed stream body are skipped.
    """

    def __init__(self, data: bytes):
        self.data = data
        self.objects: Dict[int, Any] = {}
        self._gens: Dict[int, int] = {}
        self._scan_objects()
        self._setup_decryption()
        self._expand_object_streams()
        self._pages: Optional[List[Dict[Name, Any]]] = None

    # -- parsing ------------------------------------------------------------

    def _parse_object_at(self, pos: int) -> Tuple[Any, int]:
        lex = Lexer(self.data, pos)
        value = lex.parse_value()
        if isinstance(value, tuple) and value and value[0] == "__stream__":
            _, sdict, start = value
            length = self.resolve(sdict.get("Length"))
            raw: Optional[bytes] = None
            if isinstance(length, int) and 0 <= length <= len(self.data) - start:
                candidate = self.data[start : start + length]
                tail = self.data[start + length : start + length + 20]
                if re.match(rb"\s*endstream", tail):
                    raw = candidate
            if raw is None:  # /Length wrong or indirect-and-unresolved: scan
                end = self.data.find(b"endstream", start)
                if end == -1:
                    end = len(self.data)
                raw = self.data[start:end].rstrip(b"\r\n")
            end_pos = start + len(raw)
            m = re.compile(rb"endstream").search(self.data, end_pos)
            return StreamObj(sdict, raw), (m.end() if m else end_pos)
        return value, lex.pos

    def _scan_objects(self) -> None:
        pos = 0
        n = len(self.data)
        while pos < n:
            m = _OBJ_HEADER_RE.search(self.data, pos)
            if not m:
                break
            num = int(m.group(1))
            try:
                obj, end = self._parse_object_at(m.end())
            except Exception:
                pos = m.end()
                continue
            # First definition wins unless a later one exists (linearized PDFs
            # repeat objects; incremental updates append newer versions last).
            self.objects[num] = obj
            self._gens[num] = int(m.group(2))
            pos = max(end, m.end())

    def _setup_decryption(self) -> None:
        """Open encrypted PDFs (trailer /Encrypt, standard handler) with
        the EMPTY user password — the common permissions-only encryption
        the reference's PyMuPDF opens silently. Streams and strings are
        decrypted EAGERLY per object so the rest of the pipeline never
        sees ciphertext; password-protected files raise ValueError."""
        enc_ref = file_id = None
        for m in re.finditer(rb"trailer\b", self.data):
            try:
                t = Lexer(self.data, m.end()).parse_value()
            except Exception:
                continue
            if isinstance(t, dict):
                if t.get("Encrypt") is not None:
                    enc_ref = t.get("Encrypt")
                if isinstance(t.get("ID"), list) and t["ID"]:
                    file_id = t["ID"][0]
        if enc_ref is None:  # xref-stream PDFs keep /Encrypt there instead
            for obj in self.objects.values():
                if isinstance(obj, StreamObj) and obj.dict.get("Type") == Name("XRef"):
                    if obj.dict.get("Encrypt") is not None:
                        enc_ref = obj.dict.get("Encrypt")
                        fid = obj.dict.get("ID")
                        if isinstance(fid, list) and fid:
                            file_id = fid[0]
        if enc_ref is None:
            return
        enc = self.resolve(enc_ref)
        if not isinstance(enc, dict) or enc.get("Filter") != Name("Standard"):
            raise ValueError("unsupported PDF encryption handler")
        crypt = _StdCrypt(
            enc, bytes(file_id or b""), self.resolve
        )
        enc_num = enc_ref.num if isinstance(enc_ref, Ref) else None

        def walk_strings(value, num, gen):
            if isinstance(value, bytes):
                return crypt.decrypt(value, num, gen)
            if isinstance(value, list):
                return [walk_strings(v, num, gen) for v in value]
            if isinstance(value, dict):
                return {k: walk_strings(v, num, gen) for k, v in value.items()}
            return value

        for num, obj in list(self.objects.items()):
            if num == enc_num:
                continue
            gen = self._gens.get(num, 0)
            if isinstance(obj, StreamObj):
                if obj.dict.get("Type") == Name("XRef"):
                    continue  # never encrypted (holds the xref itself)
                if crypt.encrypt_strings:
                    obj.dict = walk_strings(obj.dict, num, gen)
                if crypt.encrypt_streams:
                    obj.raw = crypt.decrypt(obj.raw, num, gen)
            elif crypt.encrypt_strings:
                self.objects[num] = walk_strings(obj, num, gen)

    def _expand_object_streams(self) -> None:
        for obj in list(self.objects.values()):
            if not (isinstance(obj, StreamObj) and obj.dict.get("Type") == Name("ObjStm")):
                continue
            try:
                payload = obj.decoded(self)
                count = int(self.resolve(obj.dict.get("N")))
                first = int(self.resolve(obj.dict.get("First")))
                header = Lexer(payload[:first])
                pairs = []
                for _ in range(count):
                    onum = header.parse_value()
                    ooff = header.parse_value()
                    pairs.append((int(onum), int(ooff)))
                for onum, ooff in pairs:
                    if onum in self.objects:
                        continue
                    lex = Lexer(payload, first + ooff)
                    value = lex.parse_value()
                    if isinstance(value, tuple) and value and value[0] == "__stream__":
                        value = value[1]  # streams are illegal in ObjStm
                    self.objects[onum] = value
            except Exception:
                continue

    # -- resolution ---------------------------------------------------------

    def resolve(self, obj: Any, depth: int = 0) -> Any:
        while isinstance(obj, Ref) and depth < 32:
            obj = self.objects.get(obj.num)
            depth += 1
        return obj

    # -- page tree ----------------------------------------------------------

    def _walk_pages(self, node: Any, inherited: Dict[Name, Any], out: List[dict]) -> None:
        node = self.resolve(node)
        if not isinstance(node, dict):
            return
        inheritable = dict(inherited)
        for key in ("Resources", "MediaBox", "CropBox", "Rotate"):
            if key in node:
                inheritable[Name(key)] = node[key]
        if node.get("Type") == Name("Page"):
            merged = dict(inheritable)
            merged.update(node)
            out.append(merged)
            return
        for kid in self.resolve(node.get("Kids")) or []:
            self._walk_pages(kid, inheritable, out)

    def pages(self) -> List[Dict[Name, Any]]:
        if self._pages is not None:
            return self._pages
        out: List[dict] = []
        root = None
        for obj in self.objects.values():
            resolved = self.resolve(obj)
            if isinstance(resolved, dict) and resolved.get("Type") == Name("Catalog"):
                root = resolved
                break
        if root is not None:
            self._walk_pages(root.get("Pages"), {}, out)
        if not out:  # damaged page tree: collect raw Page objects in order
            for num in sorted(self.objects):
                resolved = self.resolve(self.objects[num])
                if isinstance(resolved, dict) and resolved.get("Type") == Name("Page"):
                    out.append(resolved)
        self._pages = out
        return out

    @property
    def page_count(self) -> int:
        return len(self.pages())


# ---------------------------------------------------------------------------
# Fonts
# ---------------------------------------------------------------------------


def _parse_tounicode_cmap(data: bytes) -> Dict[int, str]:
    """Parse the bfchar/bfrange sections of a ToUnicode CMap."""
    mapping: Dict[int, str] = {}

    def hex_to_int(h: bytes) -> int:
        return int(h, 16)

    def hex_to_str(h: bytes) -> str:
        raw = bytes.fromhex(h.decode("ascii"))
        try:
            return raw.decode("utf-16-be")
        except UnicodeDecodeError:
            return raw.decode("latin-1", "replace")

    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", data, re.DOTALL):
        for src, dst in re.findall(rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>", m.group(1)):
            mapping[hex_to_int(src)] = hex_to_str(dst)
    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", data, re.DOTALL):
        body = m.group(1)
        # <lo> <hi> <dst>
        for lo, hi, dst in re.findall(
            rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>", body
        ):
            lo_i, hi_i = hex_to_int(lo), hex_to_int(hi)
            base = hex_to_str(dst)
            if not base:
                continue
            base_cp = ord(base[-1])
            prefix = base[:-1]
            for code in range(lo_i, min(hi_i, lo_i + 65535) + 1):
                mapping[code] = prefix + chr(base_cp + (code - lo_i))
        # <lo> <hi> [<d1> <d2> ...]
        for lo, hi, arr in re.findall(
            rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*\[(.*?)\]", body, re.DOTALL
        ):
            lo_i = hex_to_int(lo)
            dsts = re.findall(rb"<([0-9A-Fa-f]+)>", arr)
            for offset, dst in enumerate(dsts):
                mapping[lo_i + offset] = hex_to_str(dst)
    return mapping


@dataclass
class LoadedFont:
    """A PDF font prepared for rendering."""

    two_byte: bool = False  # CID font with Identity-H: 2-byte codes
    to_unicode: Dict[int, str] = field(default_factory=dict)
    widths: Dict[int, float] = field(default_factory=dict)  # code -> width/1000
    default_width: float = 0.5
    font_bytes: Optional[bytes] = None
    # CID -> glyph id map for Type0 fonts: None = Identity, else the
    # /CIDToGIDMap stream payload (2 bytes big-endian per CID).
    cid_to_gid: Optional[bytes] = None
    # PDF /Encoding /Differences for simple fonts: code -> glyph name
    # (overrides the embedded font's built-in encoding per code).
    differences: Dict[int, str] = field(default_factory=dict)
    # Type 3 fonts (PDF 1.7 §9.6.5): glyphs are PDF content streams.
    # charprocs: glyph name -> StreamObj; font_matrix maps glyph space to
    # text space; t3_resources is the font's own /Resources dict.
    charprocs: Optional[Dict[str, Any]] = None
    font_matrix: Optional[Tuple[float, ...]] = None
    t3_resources: Optional[Dict[Any, Any]] = None
    _cache: Dict[int, ImageFont.FreeTypeFont] = field(default_factory=dict)
    _ttf: object = None          # lazily parsed TrueTypeFont | False
    _t1: object = None           # lazily parsed Type1Font | False
    _glyph_cache: Dict[tuple, tuple] = field(default_factory=dict)

    def truetype(self):
        """The embedded glyph program for GLYPH-ID rendering, or None (no
        embedded bytes / unparseable). Covers TrueType (`FontFile2`) AND
        CFF (`FontFile3` Type1C/CIDFontType0C, OpenType-CFF) outlines via
        ``ttf.load_glyph_font``. Type0/Identity-H text addresses glyphs
        by id — unicode-addressed PIL rendering through a subset font's
        (often broken) cmap is exactly the round-2 fidelity gap."""
        if self._ttf is None:
            self._ttf = False
            if self.font_bytes:
                try:
                    from dots_ocr_tpu_torch.ingest.ttf import load_glyph_font

                    self._ttf = load_glyph_font(self.font_bytes)
                except Exception:
                    self._ttf = False
        return self._ttf or None

    def type1(self):
        """The embedded Type 1 (`FontFile`) program for glyph-NAME
        rendering, or None. pdfTeX-class PDFs embed Computer Modern as
        Type 1 with OT1-style built-in encodings whose codes PIL's
        unicode-addressed lookup garbles — name addressing through the
        PDF /Encoding Differences is the correct model (ingest/type1.py)."""
        if self._t1 is None:
            self._t1 = False
            if self.font_bytes and (
                self.font_bytes[:1] == b"\x80"
                or b"eexec" in self.font_bytes[:4096]
            ):
                try:
                    from dots_ocr_tpu_torch.ingest.type1 import Type1Font

                    self._t1 = Type1Font(self.font_bytes)
                except Exception:
                    self._t1 = False
        return self._t1 or None

    def glyph_name_for_code(self, code: int) -> Optional[str]:
        name = self.differences.get(code)
        if name is not None:
            return name
        t1 = self.type1()
        if t1 is not None:
            return t1.encoding.get(code)
        return None

    def t1_bitmap(self, code: int, px: int):
        """(alpha array, x_bearing, y_top) for a SIMPLE-font code via the
        embedded Type 1 program, or (None, 0, 0)."""
        key = ("t1", code, px)
        if key not in self._glyph_cache:
            t1 = self.type1()
            name = self.glyph_name_for_code(code) if t1 is not None else None
            if t1 is None or not name:
                self._glyph_cache[key] = (None, 0.0, 0.0)
            else:
                try:
                    self._glyph_cache[key] = t1.render_glyph_name(name, px)
                except Exception:
                    self._glyph_cache[key] = (None, 0.0, 0.0)
        return self._glyph_cache[key]

    def gid_for_code(self, code: int) -> int:
        if self.cid_to_gid is not None:
            i = 2 * code
            if i + 1 < len(self.cid_to_gid):
                return (self.cid_to_gid[i] << 8) | self.cid_to_gid[i + 1]
            return 0
        # CIDFontType0 (CFF) has no /CIDToGIDMap: the CFF charset defines
        # CID -> GID (PDF 32000-1 §9.7.4.2).
        f = self.truetype()
        if f is not None and getattr(f, "is_cid", False):
            return f.gid_for_cid(code)
        return code  # Identity

    def glyph_bitmap(self, code: int, px: int):
        """(alpha uint8 array, x_bearing, y_top) for a CID at px, cached;
        (None, 0, 0) when glyph rendering is unavailable/empty."""
        key = (code, px)
        if key not in self._glyph_cache:
            ttf = self.truetype()
            if ttf is None:
                self._glyph_cache[key] = (None, 0.0, 0.0)
            else:
                try:
                    self._glyph_cache[key] = ttf.render_glyph(
                        self.gid_for_code(code), px
                    )
                except Exception:
                    self._glyph_cache[key] = (None, 0.0, 0.0)
        return self._glyph_cache[key]

    def pil_font(self, px: int) -> ImageFont.ImageFont:
        px = max(1, min(px, 512))
        if px not in self._cache:
            font = None
            if self.font_bytes:
                try:
                    font = ImageFont.truetype(io.BytesIO(self.font_bytes), px)
                except Exception:
                    font = None
            if font is None:
                try:
                    font = ImageFont.load_default(size=px)
                except TypeError:
                    font = ImageFont.load_default()
            self._cache[px] = font
        return self._cache[px]

    def decode(self, raw: bytes) -> List[Tuple[int, str]]:
        """Split a string operand into (code, unicode) glyph entries."""
        out: List[Tuple[int, str]] = []
        if self.two_byte:
            for i in range(0, len(raw) - 1, 2):
                code = (raw[i] << 8) | raw[i + 1]
                out.append((code, self.to_unicode.get(code, "")))
        else:
            for b in raw:
                uni = self.to_unicode.get(b)
                if uni is None:
                    uni = bytes([b]).decode("latin-1", "replace")
                out.append((b, uni))
        return out

    def width(self, code: int) -> float:
        return self.widths.get(code, self.default_width)


def load_font(doc: PDFDocument, font_dict: Any) -> LoadedFont:
    font_dict = doc.resolve(font_dict)
    if not isinstance(font_dict, dict):
        return LoadedFont()
    font = LoadedFont()

    subtype = font_dict.get("Subtype")
    tu = doc.resolve(font_dict.get("ToUnicode"))
    if isinstance(tu, StreamObj):
        try:
            font.to_unicode = _parse_tounicode_cmap(tu.decoded(doc))
        except Exception:
            pass

    target = font_dict
    if subtype == Name("Type0"):
        font.two_byte = True
        descendants = doc.resolve(font_dict.get("DescendantFonts")) or []
        if descendants:
            target = doc.resolve(descendants[0]) or {}
        # CID widths: /W [ c [w1 w2 ...] | c1 c2 w ]
        c2g = doc.resolve(target.get("CIDToGIDMap"))
        if isinstance(c2g, StreamObj):
            try:
                font.cid_to_gid = c2g.decoded(doc)
            except Exception:
                font.cid_to_gid = None
        dw = doc.resolve(target.get("DW"))
        font.default_width = (float(dw) / 1000.0) if isinstance(dw, (int, float)) else 1.0
        w_arr = doc.resolve(target.get("W")) or []
        i = 0
        while i < len(w_arr):
            c = doc.resolve(w_arr[i])
            nxt = doc.resolve(w_arr[i + 1]) if i + 1 < len(w_arr) else None
            if isinstance(nxt, list):
                for j, w in enumerate(nxt):
                    font.widths[int(c) + j] = float(doc.resolve(w)) / 1000.0
                i += 2
            elif nxt is not None and i + 2 < len(w_arr):
                w = float(doc.resolve(w_arr[i + 2])) / 1000.0
                for code in range(int(c), int(nxt) + 1):
                    font.widths[code] = w
                i += 3
            else:
                break
    else:
        first = doc.resolve(font_dict.get("FirstChar"))
        widths = doc.resolve(font_dict.get("Widths"))
        if isinstance(first, int) and isinstance(widths, list):
            for j, w in enumerate(widths):
                w = doc.resolve(w)
                if isinstance(w, (int, float)):
                    font.widths[first + j] = float(w) / 1000.0
        # /Encoding /Differences: [code /name /name code /name ...]
        # (PDF 1.7 §9.6.6) — per-code glyph names overriding the font's
        # built-in encoding, the addressing model for Type 1 rendering.
        enc = doc.resolve(font_dict.get("Encoding"))
        diffs = doc.resolve(enc.get("Differences")) if isinstance(enc, dict) else None
        if isinstance(diffs, list):
            code = 0
            for item in diffs:
                item = doc.resolve(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                elif isinstance(item, Name):
                    font.differences[code] = str(item)
                    code += 1

    if subtype == Name("Type3"):
        fm = doc.resolve(font_dict.get("FontMatrix"))
        font.font_matrix = (
            tuple(float(doc.resolve(v)) for v in fm)
            if isinstance(fm, list) and len(fm) == 6
            else (0.001, 0.0, 0.0, 0.001, 0.0, 0.0)
        )
        procs = doc.resolve(font_dict.get("CharProcs")) or {}
        font.charprocs = {}
        for k, v in procs.items():
            v = doc.resolve(v)
            if isinstance(v, StreamObj):
                font.charprocs[str(k)] = v
        font.t3_resources = doc.resolve(font_dict.get("Resources"))
        # /Widths for Type 3 are in GLYPH space (not the /1000
        # convention): rescale through the FontMatrix x-scale.
        font.widths = {
            c: w * 1000.0 * font.font_matrix[0]
            for c, w in font.widths.items()
        }
        font.default_width = 0.0

    descriptor = doc.resolve(target.get("FontDescriptor"))
    if isinstance(descriptor, dict):
        for key in ("FontFile2", "FontFile3", "FontFile"):
            ff = doc.resolve(descriptor.get(key))
            if isinstance(ff, StreamObj):
                try:
                    font.font_bytes = ff.decoded(doc)
                except Exception:
                    font.font_bytes = None
                break
        mw = doc.resolve(descriptor.get("MissingWidth"))
        if isinstance(mw, (int, float)) and not font.two_byte:
            font.default_width = float(mw) / 1000.0
    return font


# ---------------------------------------------------------------------------
# Image XObject decoding
# ---------------------------------------------------------------------------


def _resolve_colorspace(doc: PDFDocument, cs: Any) -> Tuple[str, Optional[bytes], int]:
    """Return (pil_mode, palette_or_None, n_components)."""
    cs = doc.resolve(cs)
    if isinstance(cs, list) and cs:
        head = doc.resolve(cs[0])
        if head == Name("Indexed"):
            base_mode, _, ncomp = _resolve_colorspace(doc, cs[1])
            lookup = doc.resolve(cs[3])
            if isinstance(lookup, StreamObj):
                lookup = lookup.decoded(doc)
            if isinstance(lookup, str):
                lookup = lookup.encode("latin-1")
            return "P", bytes(lookup or b""), 1
        if head in (Name("ICCBased"),):
            stream = doc.resolve(cs[1])
            n = 3
            if isinstance(stream, StreamObj):
                n = int(doc.resolve(stream.dict.get("N")) or 3)
            return {1: ("L", None, 1), 3: ("RGB", None, 3), 4: ("CMYK", None, 4)}[n]
        if head in (Name("DeviceN"), Name("Separation")):
            return "L", None, 1
        if head in (Name("CalRGB"), Name("Lab")):
            return "RGB", None, 3
        if head == Name("CalGray"):
            return "L", None, 1
    if cs == Name("DeviceRGB"):
        return "RGB", None, 3
    if cs == Name("DeviceGray"):
        return "L", None, 1
    if cs == Name("DeviceCMYK"):
        return "CMYK", None, 4
    return "RGB", None, 3


def decode_image_xobject(doc: PDFDocument, xobj: StreamObj) -> Optional[Image.Image]:
    """Decode an image XObject to a PIL image (RGB/RGBA or L).

    /SMask soft masks (PNG-alpha-class transparency) decode as a gray
    alpha channel and return RGBA — the paster composites through it."""
    img = _decode_image_payload(doc, xobj)
    if img is None:
        return None
    smask = doc.resolve(xobj.dict.get("SMask"))
    if isinstance(smask, StreamObj):
        try:
            alpha = _decode_image_payload(doc, smask)
            if alpha is not None:
                alpha = alpha.convert("L")
                if alpha.size != img.size:
                    alpha = alpha.resize(img.size)
                img = img.convert("RGB")
                img.putalpha(alpha)
        except Exception:
            pass
    return img


def _decode_image_payload(doc: PDFDocument, xobj: StreamObj) -> Optional[Image.Image]:
    """Decode an image XObject's payload (RGB or L; mask -> L stencil)."""
    d = xobj.dict
    width = int(doc.resolve(d.get("Width") or d.get("W") or 0))
    height = int(doc.resolve(d.get("Height") or d.get("H") or 0))
    if width <= 0 or height <= 0:
        return None
    bpc = int(doc.resolve(d.get("BitsPerComponent") or d.get("BPC") or 8))
    filters = doc.resolve(d.get("Filter") or d.get("F"))
    if not isinstance(filters, list):
        filters = [filters] if filters else []
    filter_names = {str(doc.resolve(f)) for f in filters}

    data = apply_filters(d, xobj.raw, doc)
    # /Decode [1 0] inverts single-component samples (fax/gray scans).
    dec_arr = doc.resolve(d.get("Decode") or d.get("D"))
    inverted = (
        isinstance(dec_arr, list) and len(dec_arr) == 2
        and float(doc.resolve(dec_arr[0])) > float(doc.resolve(dec_arr[1]))
    )

    if filter_names & {"DCTDecode", "DCT", "JPXDecode"}:
        try:
            img = Image.open(io.BytesIO(data))
            img.load()
            return img
        except Exception:
            return None
    if filter_names & {"CCITTFaxDecode", "CCF"}:
        # Group 3/4 fax — the dominant encoding for SCANNED documents,
        # i.e. the OCR core input class. Decoded by wrapping the raw fax
        # payload in a minimal TIFF container and handing it to PIL's
        # libtiff (the standard trick: CCITT-in-PDF and CCITT-in-TIFF
        # are the same bitstream, only the framing differs).
        parms = doc.resolve(d.get("DecodeParms") or d.get("DP")) or {}
        if isinstance(parms, list):
            parms = next(
                (p for p in (doc.resolve(x) for x in parms)
                 if isinstance(p, dict) and ("K" in p or "Columns" in p)),
                {},
            )
        try:
            img = Image.open(io.BytesIO(_ccitt_to_tiff(
                data,
                width,
                height,
                k=int(doc.resolve(parms.get("K")) or 0),
                black_is_1=bool(doc.resolve(parms.get("BlackIs1"))),
                byte_align=bool(doc.resolve(parms.get("EncodedByteAlign"))),
            )))
            img.load()
            img = img.convert("L")
            return ImageChops.invert(img) if inverted else img
        except Exception:
            return None
    if filter_names & {"JBIG2Decode"}:
        # Generic regions decode in both codings: MMR (== T.6/G4, via the
        # same TIFF framing as CCITT) and arithmetic (MQ coder + template
        # contexts, ingest/jbig2.py). Symbol/text segments are not
        # supported and return None rather than garbage.
        parms = doc.resolve(d.get("DecodeParms") or d.get("DP")) or {}
        if isinstance(parms, list):
            parms = next(
                (p for p in (doc.resolve(x) for x in parms)
                 if isinstance(p, dict)), {},
            )
        gl = doc.resolve(parms.get("JBIG2Globals")) if isinstance(
            parms, dict) else None
        gl_bytes = gl.decoded(doc) if isinstance(gl, StreamObj) else b""
        try:
            img = _jbig2_decode(data, gl_bytes, width, height)
            if img is not None and inverted:
                img = ImageChops.invert(img)
            return img
        except Exception:
            return None

    is_mask = bool(doc.resolve(d.get("ImageMask") or d.get("IM")))
    if is_mask or bpc == 1:
        row_bytes = (width + 7) // 8
        img = Image.frombytes("1", (width, height), data[: row_bytes * height])
        img = img.convert("L")
        return ImageChops.invert(img) if inverted else img

    mode, palette, ncomp = _resolve_colorspace(doc, d.get("ColorSpace") or d.get("CS"))
    if bpc != 8:
        return None
    expected = width * height * ncomp
    if len(data) < expected:
        data = data + b"\x00" * (expected - len(data))
    if mode == "P":
        img = Image.frombytes("P", (width, height), data[: width * height])
        if palette:
            img.putpalette(palette[: 256 * 3])
        return img.convert("RGB")
    img = Image.frombytes(mode, (width, height), data[:expected])
    if mode == "CMYK":
        img = img.convert("RGB")
    if mode == "L" and inverted:
        img = ImageChops.invert(img)
    return img


def _jbig2_decode(
    data: bytes, globals_data: bytes, width: int, height: int
) -> Optional[Image.Image]:
    """JBIG2 embedded-in-PDF decoder for generic regions (ITU T.88).

    Walks the segment stream (embedded organization: no file header) and
    composes IMMEDIATE GENERIC REGION segments. MMR coding is exactly
    T.6/G4, decoded through the same TIFF framing the CCITT path uses;
    arithmetic coding goes through the MQ decoder + template contexts in
    `ingest/jbig2.py` (templates 0-3, custom AT, TPGDON). Symbol
    dictionaries + text regions return None: an unsupported page must
    fall through to the caller's no-image behavior, never render wrong
    bits.
    """
    import numpy as np

    page = np.zeros((height, width), bool)  # 1 = black (JBIG2 convention)
    painted = False

    def segments(buf: bytes):
        pos = 0
        n = len(buf)
        while pos + 11 <= n:
            seg_num = int.from_bytes(buf[pos : pos + 4], "big")
            flags = buf[pos + 4]
            seg_type = flags & 0x3F
            page_assoc_4 = bool(flags & 0x40)
            pos += 5
            # Referred-to segments: count in the top 3 bits, long form
            # when 7 (4-byte count + retain-bit bytes).
            rts = buf[pos]
            count = rts >> 5
            if count == 7:
                count = int.from_bytes(buf[pos : pos + 4], "big") & 0x1FFFFFFF
                pos += 4 + (count + 8) // 8
            else:
                pos += 1
            ref_size = 1 if seg_num <= 256 else (2 if seg_num <= 65536 else 4)
            if count * ref_size > n - pos:
                return  # hostile count: refs cannot fit in the buffer
            refs = [
                int.from_bytes(buf[pos + i * ref_size : pos + (i + 1) * ref_size], "big")
                for i in range(count)
            ]
            pos += count * ref_size
            pos += 4 if page_assoc_4 else 1
            length = int.from_bytes(buf[pos : pos + 4], "big")
            pos += 4
            if length == 0xFFFFFFFF:  # unknown length: cannot walk past
                return
            yield seg_num, seg_type, refs, buf[pos : pos + length]
            pos += length

    def compose(bits, rx, ry, comb_op):
        nonlocal painted
        from .jbig2 import _compose

        painted = _compose(page, bits, rx, ry, comb_op) or painted

    sym_dicts: dict = {}  # segment number -> exported symbol bitmaps
    # Hostile-stream budget: random bytes parse as plausible segment
    # headers, and each region decode costs O(rw*rh) MQ decisions — a
    # few hundred bytes must not be able to demand hundreds of
    # multi-megapixel decodes.
    pixel_budget = max(16_000_000, 8 * height * width)
    for buf in (globals_data, data):
        for seg_num, seg_type, refs, payload in segments(buf):
            if seg_type == 0:  # symbol dictionary
                from .jbig2 import decode_symbol_dictionary

                inputs = []
                for r in dict.fromkeys(refs):  # dedup: no ref amplification
                    inputs.extend(sym_dicts.get(r, []))
                syms = decode_symbol_dictionary(payload, inputs)
                if syms is None:
                    return None
                pixel_budget -= sum(s.size for s in syms if s is not None)
                sym_dicts[seg_num] = syms
                if (
                    pixel_budget < 0
                    or sum(map(len, sym_dicts.values())) > 65536
                ):
                    return None  # chained-dictionary amplification guard
                continue
            if seg_type in (6, 7):  # immediate text region
                from .jbig2 import decode_text_region

                if len(payload) >= 8:
                    pixel_budget -= int.from_bytes(
                        payload[0:4], "big"
                    ) * int.from_bytes(payload[4:8], "big")
                    if pixel_budget < 0:
                        return None
                symbols = []
                for r in refs:
                    symbols.extend(sym_dicts.get(r, []))
                res = decode_text_region(payload, symbols)
                if res is None:
                    return None
                tbits, trx, try_, tcomb = res
                compose(tbits, trx, try_, tcomb)
                continue
            if seg_type == 48 and len(payload) >= 17:
                if not painted and (payload[16] >> 2) & 1:
                    page[:] = True  # page default pixel value = 1
                continue
            if seg_type not in (36, 38, 39):  # generic region variants
                # End markers / extensions are skippable; halftone,
                # refinement, huffman tables and intermediate text
                # regions (4) mean machinery we do not have.
                if seg_type in (4, 16, 20, 22, 23, 40, 42, 43, 53):
                    return None
                continue
            if len(payload) < 18:
                return None
            rw = int.from_bytes(payload[0:4], "big")
            rh = int.from_bytes(payload[4:8], "big")
            rx = int.from_bytes(payload[8:12], "big")
            ry = int.from_bytes(payload[12:16], "big")
            comb_op = payload[16] & 0x7
            gflags = payload[17]
            if not gflags & 0x1:
                # Arithmetic generic coding (T.88 6.2): GBTEMPLATE in
                # bits 1-2, TPGDON bit 3, then the AT pixel pairs
                # (4 for template 0, 1 for templates 1-3), then MQ data.
                from .jbig2 import decode_generic_region

                template = (gflags >> 1) & 0x3
                tpgdon = bool(gflags & 0x8)
                n_at = 4 if template == 0 else 1
                at_end = 18 + 2 * n_at
                if len(payload) < at_end:
                    return None
                at = [
                    (
                        int.from_bytes(payload[i : i + 1], "big", signed=True),
                        int.from_bytes(payload[i + 1 : i + 2], "big", signed=True),
                    )
                    for i in range(18, at_end, 2)
                ]
                pixel_budget -= rw * rh
                if rw * rh > 64_000_000 or pixel_budget < 0:
                    return None  # hostile header guard
                bits = decode_generic_region(
                    payload[at_end:], rw, rh,
                    template=template, at=at, tpgdon=tpgdon,
                )
            else:
                if gflags & 0x8:
                    return None  # TPGDON with MMR is invalid anyway
                mmr = payload[18:]
                # MINISBLACK framing maps the T.6 black runs to dark
                # pixels, which is JBIG2's 1 = black convention.
                img = Image.open(io.BytesIO(_ccitt_to_tiff(
                    mmr, rw, rh, k=-1, black_is_1=False
                )))
                img.load()
                bits = np.asarray(img.convert("L")) < 128
            compose(bits, rx, ry, comb_op)
    if not painted:
        return None
    return Image.fromarray(np.where(page, 0, 255).astype(np.uint8), "L")


def _ccitt_to_tiff(
    data: bytes,
    width: int,
    height: int,
    k: int = 0,
    black_is_1: bool = False,
    byte_align: bool = False,
) -> bytes:
    """Frame a PDF CCITTFaxDecode payload as a single-strip TIFF.

    K < 0 -> Group 4 (T.6), K == 0 -> Group 3 1-D (MH), K > 0 -> Group 3
    2-D (MR, T4Options bit 0). PDF's BlackIs1=false means decoded 0 bits
    are black (TIFF BlackIsZero, photometric 1); true means 1 bits are
    black (WhiteIsZero, photometric 0). EncodedByteAlign maps to
    T4Options bit 2 for Group 3 (T.6 has no aligned mode — those rare
    streams fail decode and the caller returns None).
    """
    import struct as _struct

    compression = 4 if k < 0 else 3
    photometric = 0 if black_is_1 else 1
    entries = [
        (256, 4, width),          # ImageWidth
        (257, 4, height),         # ImageLength
        (258, 3, 1),              # BitsPerSample
        (259, 3, compression),    # Compression
        (262, 3, photometric),    # PhotometricInterpretation
        (273, 4, None),           # StripOffsets (patched below)
        (277, 3, 1),              # SamplesPerPixel
        (278, 4, height),         # RowsPerStrip
        (279, 4, len(data)),      # StripByteCounts
    ]
    if compression == 3:
        t4 = (1 if k > 0 else 0) | (4 if byte_align else 0)
        entries.append((292, 4, t4))  # T4Options
    entries.sort()
    # Header (8) + count (2) + entries (12 each) + next-IFD (4).
    data_off = 8 + 2 + 12 * len(entries) + 4
    out = bytearray(_struct.pack("<2sHI", b"II", 42, 8))
    out += _struct.pack("<H", len(entries))
    for tag, typ, val in entries:
        if val is None:
            val = data_off
        out += _struct.pack("<HHI", tag, typ, 1) + _struct.pack("<I", val)
    out += _struct.pack("<I", 0)  # no next IFD
    out += data
    return bytes(out)


# ---------------------------------------------------------------------------
# Shadings (PDF 1.7 §8.7.4): axial/radial gradients + the function types
# that drive them. Evaluated dense per device pixel with numpy.
# ---------------------------------------------------------------------------


def _eval_function(doc: "PDFDocument", fn: Any, t: "np.ndarray") -> "np.ndarray":
    """Evaluate a PDF function at 1-D inputs ``t`` -> [..., n] components.

    Types 2 (exponential), 3 (stitching), 0 (1-D sampled, linear interp),
    and arrays of 1-output functions. Unknown types raise (caller skips
    the shading — a wrong gradient is worse than none)."""
    import numpy as np

    fn = doc.resolve(fn)
    if isinstance(fn, list):
        return np.stack(
            [_eval_function(doc, f, t)[..., 0] for f in fn], axis=-1
        )
    d = fn.dict if isinstance(fn, StreamObj) else fn
    if not isinstance(d, dict):
        raise ValueError("bad function")
    ftype = int(doc.resolve(d.get("FunctionType")))
    dom = [float(doc.resolve(v)) for v in doc.resolve(d.get("Domain")) or [0, 1]]
    t = np.clip(t, dom[0], dom[1])
    if ftype == 2:
        c0 = np.asarray(
            [float(doc.resolve(v)) for v in doc.resolve(d.get("C0")) or [0.0]]
        )
        c1 = np.asarray(
            [float(doc.resolve(v)) for v in doc.resolve(d.get("C1")) or [1.0]]
        )
        n = float(doc.resolve(d.get("N")) or 1.0)
        span = (dom[1] - dom[0]) or 1.0
        u = (t - dom[0]) / span
        return c0 + (u[..., None] ** n) * (c1 - c0)
    if ftype == 3:
        fns = doc.resolve(d.get("Functions")) or []
        bounds = [float(doc.resolve(v)) for v in doc.resolve(d.get("Bounds")) or []]
        enc = [float(doc.resolve(v)) for v in doc.resolve(d.get("Encode")) or []]
        edges = [dom[0]] + bounds + [dom[1]]
        idx = np.clip(np.searchsorted(np.asarray(bounds), t, side="right"),
                      0, len(fns) - 1)
        out = None
        for i, sub in enumerate(fns):
            lo, hi = edges[i], edges[i + 1]
            e0, e1 = (enc[2 * i], enc[2 * i + 1]) if len(enc) >= 2 * i + 2 else (0.0, 1.0)
            span = (hi - lo) or 1.0
            ti = e0 + (np.clip(t, lo, hi) - lo) / span * (e1 - e0)
            vals = _eval_function(doc, sub, ti)
            if out is None:
                out = np.zeros(t.shape + (vals.shape[-1],))
            out = np.where((idx == i)[..., None], vals, out)
        if out is None:
            raise ValueError("empty stitching function")
        return out
    if ftype == 0 and isinstance(fn, StreamObj):
        size = [int(doc.resolve(v)) for v in doc.resolve(d.get("Size")) or []]
        if len(size) != 1:
            raise ValueError("only 1-D sampled functions")
        bps = int(doc.resolve(d.get("BitsPerSample")))
        rng = [float(doc.resolve(v)) for v in doc.resolve(d.get("Range")) or []]
        n_out = max(1, len(rng) // 2)
        raw = fn.decoded(doc)
        if bps == 8:
            samples = np.frombuffer(raw, np.uint8).astype(np.float64) / 255.0
        elif bps == 16:
            samples = np.frombuffer(raw, ">u2").astype(np.float64) / 65535.0
        else:
            raise ValueError(f"BitsPerSample {bps} unsupported")
        samples = samples[: size[0] * n_out].reshape(size[0], n_out)
        span = (dom[1] - dom[0]) or 1.0
        x = (t - dom[0]) / span * (size[0] - 1)
        i0 = np.clip(x.astype(np.int64), 0, size[0] - 1)
        i1 = np.minimum(i0 + 1, size[0] - 1)
        frac = (x - i0)[..., None]
        vals = samples[i0] * (1 - frac) + samples[i1] * frac
        if rng:
            lo = np.asarray(rng[0::2])
            hi = np.asarray(rng[1::2])
            vals = lo + vals * (hi - lo)
        return vals
    raise ValueError(f"FunctionType {ftype} unsupported")


def _components_to_rgb(comps: "np.ndarray") -> "np.ndarray":
    """[..., n] function output -> [..., 3] uint8 RGB (n = 1 gray,
    3 RGB, 4 CMYK)."""
    import numpy as np

    comps = np.clip(comps, 0.0, 1.0)
    n = comps.shape[-1]
    if n == 1:
        rgb = np.repeat(comps, 3, axis=-1)
    elif n == 4:
        c, m, y, k = (comps[..., i] for i in range(4))
        rgb = np.stack(
            [(1 - np.minimum(1, c + k)), (1 - np.minimum(1, m + k)),
             (1 - np.minimum(1, y + k))], axis=-1
        )
    else:
        rgb = comps[..., :3]
    return (rgb * 255.0 + 0.5).astype("uint8")


# ---------------------------------------------------------------------------
# Content-stream rasterizer
# ---------------------------------------------------------------------------

Matrix = Tuple[float, float, float, float, float, float]  # a b c d e f

IDENTITY: Matrix = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def mat_mul(m1: Matrix, m2: Matrix) -> Matrix:
    """Row-vector convention: point' = point @ m1 @ m2."""
    a1, b1, c1, d1, e1, f1 = m1
    a2, b2, c2, d2, e2, f2 = m2
    return (
        a1 * a2 + b1 * c2,
        a1 * b2 + b1 * d2,
        c1 * a2 + d1 * c2,
        c1 * b2 + d1 * d2,
        e1 * a2 + f1 * c2 + e2,
        e1 * b2 + f1 * d2 + f2,
    )


def mat_apply(m: Matrix, x: float, y: float) -> Tuple[float, float]:
    a, b, c, d, e, f = m
    return (a * x + c * y + e, b * x + d * y + f)


def _flatten_cubic(
    p0: Tuple[float, float],
    p1: Tuple[float, float],
    p2: Tuple[float, float],
    p3: Tuple[float, float],
    steps: int = 12,
) -> List[Tuple[float, float]]:
    """Flatten a cubic Bezier (excluding p0) with uniform-t subdivision."""
    out: List[Tuple[float, float]] = []
    for i in range(1, steps + 1):
        t = i / steps
        u = 1.0 - t
        uu, tt = u * u, t * t
        b0, b1, b2, b3 = uu * u, 3.0 * uu * t, 3.0 * u * tt, tt * t
        out.append((
            b0 * p0[0] + b1 * p1[0] + b2 * p2[0] + b3 * p3[0],
            b0 * p0[1] + b1 * p1[1] + b2 * p2[1] + b3 * p3[1],
        ))
    return out


@dataclass
class GraphicsState:
    ctm: Matrix = IDENTITY
    fill_rgb: Tuple[int, int, int] = (0, 0, 0)
    stroke_rgb: Tuple[int, int, int] = (0, 0, 0)
    line_width: float = 1.0
    font: Optional[LoadedFont] = None
    font_size: float = 12.0
    char_spacing: float = 0.0
    word_spacing: float = 0.0
    h_scale: float = 1.0
    leading: float = 0.0
    rise: float = 0.0
    # Device-space clip mask ("L", 255 = visible), None = unclipped.
    # Masks are immutable once installed (intersection builds a new
    # image), so clones share the reference.
    clip: Optional[Image.Image] = None
    # Shading-pattern fill (PatternType 2 set via scn): (shading obj,
    # pattern Matrix). Solid-color operators clear it.
    fill_shading: Optional[tuple] = None
    # ExtGState constant alpha (/ca fill, /CA stroke): 1.0 = opaque.
    fill_alpha: float = 1.0
    stroke_alpha: float = 1.0
    # Tiling-pattern fill (PatternType 1 set via scn): (pattern stream,
    # pattern Matrix).
    fill_tiling: Optional[tuple] = None
    # Text rendering mode (Tr, PDF 1.7 §9.3.6): 3/7 = invisible — the
    # searchable-scan OCR text layer, which must NOT paint over the scan.
    text_mode: int = 0

    def clone(self) -> "GraphicsState":
        return GraphicsState(
            self.ctm, self.fill_rgb, self.stroke_rgb, self.line_width,
            self.font, self.font_size,
            self.char_spacing, self.word_spacing, self.h_scale,
            self.leading, self.rise, self.clip, self.fill_shading,
            self.fill_alpha, self.stroke_alpha, self.fill_tiling,
            self.text_mode,
        )


def _tokenize_content(data: bytes):
    """Yield ('op', name) and ('val', value) tokens from a content stream."""
    lex = Lexer(data)
    n = len(data)
    while True:
        lex._skip_ws()
        if lex.pos >= n:
            return
        c = data[lex.pos : lex.pos + 1]
        if c in b"/<([+-.0123456789":
            try:
                yield ("val", lex.parse_value())
            except Exception:
                lex.pos += 1
            continue
        m = re.match(rb"[A-Za-z'\"*0-9]+", data[lex.pos :])
        if not m:
            lex.pos += 1
            continue
        op = m.group().decode("latin-1")
        lex.pos += m.end()
        if op == "BI":  # inline image: parse dict then binary payload
            d: Dict[Name, Any] = {}
            while True:
                lex._skip_ws()
                if data[lex.pos : lex.pos + 2] == b"ID":
                    lex.pos += 2
                    break
                try:
                    key = lex._parse_name()
                    d[key] = lex.parse_value()
                except Exception:
                    break
            if data[lex.pos : lex.pos + 1] in b" \r\n":
                lex.pos += 1
            end = data.find(b"EI", lex.pos)
            while end != -1 and end + 2 < n and data[end + 2 : end + 3] not in b" \r\n\t[]</(%" + b"":
                end = data.find(b"EI", end + 1)
            if end == -1:
                end = n
            payload = data[lex.pos : end].rstrip(b"\r\n")
            lex.pos = min(end + 2, n)
            yield ("inline_image", (d, payload))
            continue
        if op in ("true", "false", "null"):
            yield ("val", {"true": True, "false": False, "null": None}[op])
            continue
        yield ("op", op)


class PageRasterizer:
    """Rasterize one PDF page to a PIL RGB image at a given DPI."""

    def __init__(self, doc: PDFDocument, page: Dict[Name, Any], dpi: float = 72.0):
        self.doc = doc
        self.page = page
        media = [float(doc.resolve(v)) for v in (doc.resolve(page.get("MediaBox")) or [0, 0, 612, 792])]
        # Viewers (and PyMuPDF's get_pixmap) render the CropBox — the
        # visible region — intersected with the MediaBox; normalize corner
        # order (some producers store decreasing coordinates).
        crop = doc.resolve(page.get("CropBox"))
        if isinstance(crop, list) and len(crop) == 4:
            c = [float(doc.resolve(v)) for v in crop]
            cx0, cx1 = sorted((c[0], c[2]))
            cy0, cy1 = sorted((c[1], c[3]))
            mx0, mx1 = sorted((media[0], media[2]))
            my0, my1 = sorted((media[1], media[3]))
            x0, x1 = max(cx0, mx0), min(cx1, mx1)
            y0, y1 = max(cy0, my0), min(cy1, my1)
            if x1 - x0 < 1 or y1 - y0 < 1:
                x0, y0, x1, y1 = mx0, my0, mx1, my1
        else:
            x0, x1 = sorted((media[0], media[2]))
            y0, y1 = sorted((media[1], media[3]))
        self.scale = dpi / 72.0
        # Canvas guard: a corrupt/hostile MediaBox (e.g. [0 0 1e9 1e9])
        # must not demand a multi-GB allocation — the ingest policy's
        # 4500px -> 72dpi fallback (pdf.py::render_page_image) only runs
        # AFTER a successful render. Clamp the scale so the canvas stays
        # within PIL-safe bounds; legitimate pages (<= ~22.5in at 200 dpi,
        # metre-long receipts at 72 dpi) are far below the cap.
        pw, ph = max(x1 - x0, 1e-3), max(y1 - y0, 1e-3)
        max_side, max_pixels = 65_000.0, 1.5e8
        cap = min(max_side / pw, max_side / ph,
                  (max_pixels / (pw * ph)) ** 0.5)
        if self.scale > cap:
            self.scale = cap
        self.width = max(1, round(pw * self.scale))
        self.height = max(1, round(ph * self.scale))
        # PDF user space (y up) -> device pixels (y down).
        self.base: Matrix = mat_mul(
            (1, 0, 0, 1, -x0, -y0),
            (self.scale, 0.0, 0.0, -self.scale, 0.0, y1 * self.scale - y0 * self.scale),
        )
        # Page /Rotate (90-degree steps, clockwise display): compose the
        # rotation into the base map and swap the canvas dims for 90/270 —
        # rotated scanned pages (stored landscape) render upright, like
        # PyMuPDF's get_pixmap.
        rot = int(doc.resolve(page.get("Rotate")) or 0) % 360
        w0, h0 = self.width, self.height
        if rot == 90:
            self.base = mat_mul(self.base, (0.0, 1.0, -1.0, 0.0, float(h0), 0.0))
            self.width, self.height = h0, w0
        elif rot == 180:
            self.base = mat_mul(
                self.base, (-1.0, 0.0, 0.0, -1.0, float(w0), float(h0))
            )
        elif rot == 270:
            self.base = mat_mul(self.base, (0.0, -1.0, 1.0, 0.0, 0.0, float(w0)))
            self.width, self.height = h0, w0
        self.canvas = Image.new("RGB", (self.width, self.height), (255, 255, 255))
        self.draw = ImageDraw.Draw(self.canvas)
        self._font_cache: Dict[int, LoadedFont] = {}

    # -- resources ----------------------------------------------------------

    def _resources(self, page_or_form: Dict[Name, Any]) -> Dict[Name, Any]:
        return self.doc.resolve(page_or_form.get("Resources")) or {}

    def _get_font(self, resources: Dict[Name, Any], name: str) -> LoadedFont:
        fonts = self.doc.resolve(resources.get("Font")) or {}
        ref = fonts.get(Name(name))
        key = id(ref) if not isinstance(ref, Ref) else ref.num
        if key not in self._font_cache:
            self._font_cache[key] = load_font(self.doc, ref)
        return self._font_cache[key]

    # -- drawing ------------------------------------------------------------

    def _paste_image(self, img: Image.Image, ctm: Matrix, fill_rgb=(0, 0, 0),
                     is_mask=False, clip: Optional[Image.Image] = None,
                     alpha: float = 1.0) -> None:
        """Map the image's unit square through ctm∘base onto the canvas."""
        m = mat_mul(ctm, self.base)
        corners = [mat_apply(m, x, y) for x, y in ((0, 0), (1, 0), (0, 1), (1, 1))]
        xs = [p[0] for p in corners]
        ys = [p[1] for p in corners]
        x_min, x_max = min(xs), max(xs)
        y_min, y_max = min(ys), max(ys)
        out_w = max(1, round(x_max - x_min))
        out_h = max(1, round(y_max - y_min))
        if out_w <= 0 or out_h <= 0 or x_min >= self.width or y_min >= self.height:
            return
        if x_max < 0 or y_max < 0:
            return

        a, b, c, d, e, f = m
        axis_aligned = abs(b) < 1e-9 and abs(c) < 1e-9
        if is_mask:
            # Stencil mask: 0 bits paint fill color (PDF semantics: sample 0
            # = paint). Our "1" conversion gave 255 for set bits.
            color_img = Image.new("RGB", img.size, fill_rgb)
            mask = img.point(lambda v: 255 - v)
            src = color_img
        elif img.mode in ("RGBA", "LA", "PA"):
            # Soft-masked image (/SMask): the alpha channel gates the paste.
            mask = img.getchannel("A")
            src = img.convert("RGB")
        else:
            src = img.convert("RGB")
            mask = None

        if axis_aligned:
            resized = src.resize((out_w, out_h))
            mask_resized = mask.resize((out_w, out_h)) if mask is not None else None
            # Flips: negative a/d mean the unit square maps reversed.
            if a < 0:
                resized = resized.transpose(Image.FLIP_LEFT_RIGHT)
                if mask_resized is not None:
                    mask_resized = mask_resized.transpose(Image.FLIP_LEFT_RIGHT)
            if d > 0:  # device y grows downward; ctm with d>0 after flip = upside down
                pass
            else:
                pass
            # In device space the unit square's (0,1) corner is the image top
            # in the common case (d<0 pre-flip). The corner mapping already
            # accounts for orientation via min/max; PDF images draw top row
            # at v=1. Determine vertical flip from where v=1 lands:
            top_left_v1 = mat_apply(m, 0, 1)
            if top_left_v1[1] > min(ys) + 1e-6:
                resized = resized.transpose(Image.FLIP_TOP_BOTTOM)
                if mask_resized is not None:
                    mask_resized = mask_resized.transpose(Image.FLIP_TOP_BOTTOM)
            px0, py0 = round(x_min), round(y_min)
            if alpha < 1.0:
                mask_resized = (
                    Image.new("L", (out_w, out_h), int(alpha * 255))
                    if mask_resized is None
                    else mask_resized.point(lambda v: int(v * alpha))
                )
            if clip is not None:
                clip_crop = clip.crop((px0, py0, px0 + out_w, py0 + out_h))
                mask_resized = (
                    clip_crop if mask_resized is None
                    else ImageChops.multiply(mask_resized, clip_crop)
                )
            self.canvas.paste(resized, (px0, py0), mask_resized)
        else:
            # General affine: compute output->source mapping for PIL.
            det = a * d - b * c
            if abs(det) < 1e-12:
                return
            # forward: (u,v) unit -> device; source pixel (px,py): u=px/w, v=1-py/h
            w0, h0 = src.size
            inv_a, inv_b = d / det, -b / det
            inv_c, inv_d = -c / det, a / det

            def src_coeffs():
                # device (X,Y) -> unit: u = inv_a*(X-e') + inv_c*(Y-f') ...
                e2 = x_min
                f2 = y_min
                # unit coords of output pixel (ox,oy): first device = (ox+x_min, oy+y_min)
                # u = inv_a*(dx-e) + inv_c*(dy-f); v = inv_b*(dx-e) + inv_d*(dy-f)
                # src px = u*w0; py = (1-v)*h0
                A = inv_a * w0
                B = inv_c * w0
                C = (inv_a * (e2 - e) + inv_c * (f2 - f)) * w0
                D = -inv_b * h0
                E = -inv_d * h0
                F = (1 - (inv_b * (e2 - e) + inv_d * (f2 - f))) * h0
                return (A, B, C, D, E, F)

            coeffs = src_coeffs()
            region = src.transform((out_w, out_h), Image.AFFINE, coeffs, fillcolor=(255, 255, 255))
            if mask is not None:
                mask_region = mask.transform((out_w, out_h), Image.AFFINE, coeffs, fillcolor=0)
            else:
                mask_region = Image.new("L", (out_w, out_h), 255)
                mask_region = mask_region.transform(
                    (out_w, out_h), Image.AFFINE, (1, 0, 0, 0, 1, 0)
                )
                # Build coverage mask so out-of-quad pixels stay transparent.
                cov = Image.new("L", src.size, 255)
                mask_region = cov.transform((out_w, out_h), Image.AFFINE, coeffs, fillcolor=0)
            px0, py0 = round(x_min), round(y_min)
            if alpha < 1.0:
                mask_region = mask_region.point(lambda v: int(v * alpha))
            if clip is not None:
                mask_region = ImageChops.multiply(
                    mask_region,
                    clip.crop((px0, py0, px0 + out_w, py0 + out_h)),
                )
            self.canvas.paste(region, (px0, py0), mask_region)

    def _paint_path(
        self,
        subpaths: List[Tuple[List[Tuple[float, float]], bool]],
        gs: GraphicsState,
        fill: bool,
        stroke: bool,
    ) -> None:
        """Paint constructed subpaths in device space.

        Fills use PIL's scanline polygon fill (per-subpath — adequate for the
        cell shadings, rules, and simple figures that occur in documents;
        compound even-odd holes across subpaths are approximated). Strokes
        flatten to polylines with the line width scaled by the CTM.
        """
        m = mat_mul(gs.ctm, self.base)
        if fill and gs.fill_tiling is not None:
            mask = self._path_clip_mask(subpaths, gs.ctm)
            if mask is not None:
                self._paint_tiling(
                    gs.fill_tiling, gs.clip, mask, gs.fill_alpha
                )
            if not stroke:
                return
            fill = False
        if fill and gs.fill_shading is not None:
            # Shading-pattern fill: the path becomes a mask and the
            # gradient paints through it. Pattern space maps through the
            # pattern Matrix to the DEFAULT page space (PDF 1.7 §8.7.3.1),
            # not the CTM at fill time.
            shading, pat_m = gs.fill_shading
            mask = self._path_clip_mask(subpaths, gs.ctm)
            if mask is not None:
                self._paint_shading(
                    shading, mat_mul(pat_m, self.base), gs.clip, mask=mask,
                    alpha=gs.fill_alpha,
                )
            if not stroke:
                return
            fill = False
        if stroke:
            a, b, c, d, _, _ = m
            scale = math.sqrt(abs(a * d - b * c)) or 1.0
            width = max(1, round(gs.line_width * scale))
        if gs.clip is None and gs.fill_alpha >= 1.0 and gs.stroke_alpha >= 1.0:
            for pts, closed in subpaths:
                device = [mat_apply(m, x, y) for x, y in pts]
                if fill and len(device) >= 3:
                    self.draw.polygon(device, fill=gs.fill_rgb)
                if stroke and len(device) >= 2:
                    line_pts = device + device[:1] if closed else device
                    self.draw.line(line_pts, fill=gs.stroke_rgb, width=width)
            return
        # Clipped and/or translucent: rasterize the op as an "L" coverage
        # mask, scale by the constant alpha, intersect with the clip, and
        # paste the flat color through it (fill and stroke get separate
        # passes — they carry different colors and alphas).
        for do_it, color, alpha, as_fill in (
            (fill, gs.fill_rgb, gs.fill_alpha, True),
            (stroke, gs.stroke_rgb, gs.stroke_alpha, False),
        ):
            if not do_it:
                continue
            ink = max(0, min(255, int(round(alpha * 255))))
            shape = Image.new("L", self.canvas.size, 0)
            sd = ImageDraw.Draw(shape)
            for pts, closed in subpaths:
                device = [mat_apply(m, x, y) for x, y in pts]
                if as_fill and len(device) >= 3:
                    sd.polygon(device, fill=ink)
                elif not as_fill and len(device) >= 2:
                    line_pts = device + device[:1] if closed else device
                    sd.line(line_pts, fill=ink, width=width)
            if gs.clip is not None:
                shape = ImageChops.multiply(shape, gs.clip)
            self.canvas.paste(color, (0, 0), shape)

    def _path_clip_mask(
        self,
        subpaths: List[Tuple[List[Tuple[float, float]], bool]],
        ctm: Matrix,
    ) -> Optional[Image.Image]:
        """Device-space coverage mask of the path for W/W* (both winding
        rules approximated by the same per-subpath scanline fill the
        painter uses). None when no subpath can enclose area — a broken
        parse must not white out the page."""
        m = mat_mul(ctm, self.base)
        mask = None
        for pts, _closed in subpaths:
            if len(pts) < 3:
                continue
            if mask is None:
                mask = Image.new("L", (self.width, self.height), 0)
                md = ImageDraw.Draw(mask)
            md.polygon([mat_apply(m, x, y) for x, y in pts], fill=255)
        return mask

    def _paint_shading(
        self,
        shading: Any,
        user_to_device: Matrix,
        clip: Optional[Image.Image],
        mask: Optional[Image.Image] = None,
        alpha: float = 1.0,
    ) -> None:
        """Rasterize an axial (Type 2) / radial (Type 3) shading densely
        over the canvas, gated by ``clip`` and an optional path ``mask``
        (shading-pattern fills). Coordinates are in the space mapped by
        ``user_to_device``; uncovered pixels (Extend false) stay
        untouched."""
        import numpy as np

        sh = self.doc.resolve(shading)
        d = sh.dict if isinstance(sh, StreamObj) else sh
        if not isinstance(d, dict):
            return
        stype = int(self.doc.resolve(d.get("ShadingType")) or 0)
        if stype in (4, 5, 6, 7) and isinstance(sh, StreamObj):
            self._paint_mesh_shading(sh, user_to_device, clip, mask, alpha)
            return
        if stype not in (2, 3):
            return
        coords = [
            float(self.doc.resolve(v))
            for v in self.doc.resolve(d.get("Coords")) or []
        ]
        dom = [
            float(self.doc.resolve(v))
            for v in self.doc.resolve(d.get("Domain")) or [0.0, 1.0]
        ]
        ext = self.doc.resolve(d.get("Extend")) or [False, False]
        e0 = bool(self.doc.resolve(ext[0])) if len(ext) > 0 else False
        e1 = bool(self.doc.resolve(ext[1])) if len(ext) > 1 else False

        a, b, c, dd, e, f = user_to_device
        det = a * dd - b * c
        if abs(det) < 1e-12:
            return
        # Device pixel centers -> shading space.
        xs = np.arange(self.width) + 0.5
        ys = np.arange(self.height) + 0.5
        dx, dy = np.meshgrid(xs, ys)  # [H, W]
        ux = (dd * (dx - e) - c * (dy - f)) / det
        uy = (-b * (dx - e) + a * (dy - f)) / det

        if stype == 2 and len(coords) >= 4:
            x0, y0, x1, y1 = coords[:4]
            ax, ay = x1 - x0, y1 - y0
            denom = ax * ax + ay * ay
            if denom < 1e-12:
                return
            s = ((ux - x0) * ax + (uy - y0) * ay) / denom
            covered = ((s >= 0) | e0) & ((s <= 1) | e1)
            s = np.clip(s, 0.0, 1.0)
        elif stype == 3 and len(coords) >= 6:
            x0, y0, r0, x1, y1, r1 = coords[:6]
            dcx, dcy, dr = x1 - x0, y1 - y0, r1 - r0
            px, py = ux - x0, uy - y0
            A = dcx * dcx + dcy * dcy - dr * dr
            B = px * dcx + py * dcy + r0 * dr
            C = px * px + py * py - r0 * r0
            with np.errstate(invalid="ignore", divide="ignore"):
                if abs(A) < 1e-9:
                    s = C / (2.0 * np.where(np.abs(B) < 1e-12, np.nan, B))
                    valid = np.isfinite(s)
                else:
                    disc = B * B - A * C
                    valid = disc >= 0
                    root = np.sqrt(np.maximum(disc, 0.0))
                    # Larger s first (the outermost circle wins); fall
                    # back to the other root where r(s) < 0.
                    s1 = (B + root) / A
                    s2 = (B - root) / A
                    s = np.where(r0 + s1 * dr >= 0, s1, s2)
                valid &= (r0 + s * dr) >= 0
            covered = valid & ((s >= 0) | e0) & ((s <= 1) | e1)
            s = np.clip(np.nan_to_num(s), 0.0, 1.0)
        else:
            return

        t = dom[0] + s * (dom[1] - dom[0])
        try:
            comps = _eval_function(self.doc, d.get("Function"), t)
        except Exception:
            return
        rgb = _components_to_rgb(comps)
        img = Image.fromarray(rgb, "RGB")
        cover = Image.fromarray(
            (covered.astype("uint8") * 255), "L"
        )
        if alpha < 1.0:
            cover = cover.point(lambda v: int(v * alpha))
        if mask is not None:
            cover = ImageChops.multiply(cover, mask)
        if clip is not None:
            cover = ImageChops.multiply(cover, clip)
        self.canvas.paste(img, (0, 0), cover)

    def _paint_tiling(
        self,
        tiling: tuple,
        clip: Optional[Image.Image],
        mask: Image.Image,
        alpha: float = 1.0,
    ) -> None:
        """Fill through a PatternType 1 (tiling) pattern: render ONE cell
        in PATTERN SPACE by executing the pattern's content stream, tile
        it over the canvas's pattern-space footprint, and map the tiled
        raster to device space with one affine transform — general
        pattern matrices (incl. rotation/skew) supported. Cells render
        over white, so unmarked cell area approximates as white rather
        than transparent — fine for document backgrounds, the common
        use."""
        import numpy as np

        pat, pmat = tiling
        d = pat.dict
        p2d = mat_mul(pmat, self.base)  # pattern space -> device px
        a, b, c, dd, e, f = p2d
        det = a * dd - b * c
        if abs(det) < 1e-12:
            return
        s = math.sqrt(abs(det))  # pattern units -> device px scale
        bbox = [
            float(self.doc.resolve(v))
            for v in self.doc.resolve(d.get("BBox")) or [0, 0, 1, 1]
        ]
        bx0, by0 = min(bbox[0], bbox[2]), min(bbox[1], bbox[3])
        xstep = abs(float(self.doc.resolve(d.get("XStep")) or 0)) or abs(
            bbox[2] - bbox[0]
        ) or 1.0
        ystep = abs(float(self.doc.resolve(d.get("YStep")) or 0)) or abs(
            bbox[3] - bbox[1]
        ) or 1.0
        tw = max(1, round(xstep * s))
        th = max(1, round(ystep * s))
        if tw > self.width * 4 or th > self.height * 4:
            return
        # Render one cell: pattern rect [bx0, bx0+xstep) x [by0, by0+ystep)
        # onto a (tw, th) raster, y flipped to image convention.
        tile = Image.new("RGB", (tw, th), (255, 255, 255))
        saved = (self.canvas, self.draw, self.base, self.width, self.height)
        self.canvas, self.draw = tile, ImageDraw.Draw(tile)
        self.base = mat_mul(
            (1.0, 0.0, 0.0, 1.0, -bx0, -by0), (s, 0.0, 0.0, -s, 0.0, float(th))
        )
        self.width, self.height = tw, th
        try:
            self._execute(
                pat.decoded(self.doc),
                self.doc.resolve(d.get("Resources")) or {},
                GraphicsState(),
                depth=7,
            )
        except Exception:
            pass
        finally:
            self.canvas, self.draw, self.base, self.width, self.height = saved
        # Pattern-space footprint of the device canvas (inverse corners).
        W, H = self.width, self.height
        inv = lambda X, Y: (  # noqa: E731 — device -> pattern space
            (dd * (X - e) - c * (Y - f)) / det,
            (-b * (X - e) + a * (Y - f)) / det,
        )
        corners = [inv(0, 0), inv(W, 0), inv(0, H), inv(W, H)]
        pxs = [p[0] for p in corners]
        pys = [p[1] for p in corners]
        k0 = math.floor((min(pxs) - bx0) / xstep)
        k1 = math.floor((max(pxs) - bx0) / xstep)
        l0 = math.floor((min(pys) - by0) / ystep)
        l1 = math.floor((max(pys) - by0) / ystep)
        nx, ny = k1 - k0 + 1, l1 - l0 + 1
        if nx < 1 or ny < 1:
            return
        # Cap the BIG RASTER, not the tile count: fine hatches (4-unit
        # periods on a letter page) legitimately need tens of thousands
        # of small tiles, and their raster stays page-sized.
        if (nx * tw) * (ny * th) > 16 * self.width * self.height + (1 << 22):
            return
        big = np.tile(np.asarray(tile), (ny, nx, 1))
        big_h = ny * th
        ox = bx0 + k0 * xstep
        oy = by0 + l0 * ystep
        # Image.transform wants DEVICE -> big-raster coeffs:
        #   u = s*(px - ox); v = big_h - s*(py - oy), px/py from inv().
        A = s * dd / det
        B = -s * c / det
        C = s * ((c * f - dd * e) / det - ox)
        D = s * b / det
        E = -s * a / det
        F = big_h - s * ((b * e - a * f) / det - oy)
        full = Image.fromarray(big, "RGB").transform(
            (W, H), Image.AFFINE, (A, B, C, D, E, F),
            fillcolor=(255, 255, 255),
        )
        cover = mask
        if alpha < 1.0:
            cover = cover.point(lambda v: int(v * alpha))
        if clip is not None:
            cover = ImageChops.multiply(cover, clip)
        self.canvas.paste(full, (0, 0), cover)

    def _paint_mesh_shading(
        self,
        sh: "StreamObj",
        user_to_device: Matrix,
        clip: Optional[Image.Image],
        mask: Optional[Image.Image],
        alpha: float,
    ) -> None:
        """Mesh shadings (types 4-7, PDF 1.7 §8.7.4.5.5-8): decode the
        packed vertex stream and Gouraud-rasterize triangles with numpy
        barycentrics. Coons/tensor patches (6/7) are approximated by two
        triangles over their four corner points — adequate for the soft
        background gradients they carry in documents."""
        import numpy as np

        d = sh.dict
        rs = self.doc.resolve
        stype = int(rs(d.get("ShadingType")))
        bpc = int(rs(d.get("BitsPerCoordinate")) or 16)
        bpcomp = int(rs(d.get("BitsPerComponent")) or 8)
        bpf = int(rs(d.get("BitsPerFlag")) or 8)
        dec = [float(rs(v)) for v in rs(d.get("Decode")) or []]
        if len(dec) < 6:
            return
        fn = d.get("Function")
        _, _, cs_n = _resolve_colorspace(self.doc, d.get("ColorSpace"))
        ncomp = 1 if fn is not None else cs_n
        data = sh.decoded(self.doc)

        pos = 0  # bit cursor

        def bits(n):
            nonlocal pos
            byte0 = pos // 8
            raw = int.from_bytes(
                data[byte0 : byte0 + (pos % 8 + n + 7) // 8], "big"
            )
            shift = ((pos % 8 + n + 7) // 8) * 8 - (pos % 8) - n
            pos += n
            return (raw >> shift) & ((1 << n) - 1)

        def val(nbits, lo, hi):
            return lo + bits(nbits) / ((1 << nbits) - 1) * (hi - lo)

        def align():
            # Per ISO 32000-1 §8.7.4.5.5-8 each vertex record (type 4),
            # row (type 5), and patch (6/7) is padded to a byte boundary;
            # a no-op for the common byte-aligned encodings.
            nonlocal pos
            pos = (pos + 7) // 8 * 8

        def vertex():
            x = val(bpc, dec[0], dec[1])
            y = val(bpc, dec[2], dec[3])
            comps = tuple(
                val(bpcomp, dec[4 + 2 * i], dec[5 + 2 * i])
                for i in range(ncomp)
            )
            return (x, y), comps

        total_bits = len(data) * 8
        need = bpc * 2 + bpcomp * ncomp
        tris = []  # ((pt, comps) x 3)
        try:
            if stype == 4:
                va = vb = vc = None
                while pos + bpf + need <= total_bits:
                    f = bits(bpf)
                    v = vertex()
                    if f == 0:
                        if pos + 2 * (bpf + need) > total_bits:
                            break
                        align()
                        bits(bpf)
                        v2 = vertex()
                        align()
                        bits(bpf)
                        v3 = vertex()
                        va, vb, vc = v, v2, v3
                    elif f == 1 and vc is not None:
                        va, vb, vc = vb, vc, v
                    elif f == 2 and vc is not None:
                        vb, vc = vc, v
                    else:
                        break
                    align()
                    tris.append((va, vb, vc))
            elif stype == 5:
                per_row = int(rs(d.get("VerticesPerRow")) or 0)
                if per_row < 2:
                    return
                rows = []
                while pos + need <= total_bits:
                    row = [vertex() for _ in range(per_row)
                           if pos + need <= total_bits]
                    if len(row) < per_row:
                        break
                    align()
                    rows.append(row)
                for r0, r1 in zip(rows, rows[1:]):
                    for i in range(per_row - 1):
                        tris.append((r0[i], r0[i + 1], r1[i]))
                        tris.append((r0[i + 1], r1[i + 1], r1[i]))
            else:  # 6 / 7: corner-triangle approximation
                npts_new = 12 if stype == 6 else 16
                npts_cont = 8 if stype == 6 else 12
                prev_pts = prev_cols = None
                while pos + bpf <= total_bits:
                    f = bits(bpf)
                    npts = npts_new if f == 0 else npts_cont
                    ncols = 4 if f == 0 else 2
                    if pos + npts * 2 * bpc + ncols * bpcomp * ncomp > total_bits:
                        break
                    pts = [
                        (val(bpc, dec[0], dec[1]), val(bpc, dec[2], dec[3]))
                        for _ in range(npts)
                    ]
                    cols = [
                        tuple(
                            val(bpcomp, dec[4 + 2 * i], dec[5 + 2 * i])
                            for i in range(ncomp)
                        )
                        for _ in range(ncols)
                    ]
                    if f == 0:
                        corners = [pts[0], pts[3], pts[6], pts[9]]
                        ccols = cols
                    elif prev_pts is not None:
                        # Continuation shares one edge; approximate with the
                        # new points' first/mid/last as three fresh corners.
                        corners = [prev_pts[3], prev_pts[2],
                                   pts[2] if len(pts) > 2 else pts[-1],
                                   pts[5] if len(pts) > 5 else pts[-1]]
                        ccols = [prev_cols[2], prev_cols[3], cols[0], cols[1]]
                    else:
                        break
                    tris.append((
                        (corners[0], ccols[0]), (corners[1], ccols[1]),
                        (corners[2], ccols[2]),
                    ))
                    tris.append((
                        (corners[0], ccols[0]), (corners[2], ccols[2]),
                        (corners[3], ccols[3]),
                    ))
                    align()
                    prev_pts, prev_cols = corners, ccols
        except Exception:
            pass
        if not tris:
            return

        rgb_cache: Dict[tuple, "np.ndarray"] = {}

        def to_rgb(comps):
            got = rgb_cache.get(comps)
            if got is None:
                if fn is not None:
                    arr = _eval_function(self.doc, fn, np.asarray([comps[0]]))
                    got = _components_to_rgb(arr)[0]
                else:
                    got = _components_to_rgb(np.asarray(comps, np.float64))
                rgb_cache[comps] = got
            return got

        W, H = self.width, self.height
        overlay = np.zeros((H, W, 3), np.uint8)
        covered = np.zeros((H, W), bool)
        for (p0, c0), (p1, c1), (p2, c2) in tris:
            d0 = mat_apply(user_to_device, *p0)
            d1 = mat_apply(user_to_device, *p1)
            d2 = mat_apply(user_to_device, *p2)
            xs = [d0[0], d1[0], d2[0]]
            ys = [d0[1], d1[1], d2[1]]
            x0 = max(0, int(math.floor(min(xs))))
            x1 = min(W, int(math.ceil(max(xs))) + 1)
            y0 = max(0, int(math.floor(min(ys))))
            y1 = min(H, int(math.ceil(max(ys))) + 1)
            if x1 <= x0 or y1 <= y0:
                continue
            area = (
                (d1[0] - d0[0]) * (d2[1] - d0[1])
                - (d2[0] - d0[0]) * (d1[1] - d0[1])
            )
            if abs(area) < 1e-9:
                continue
            gx, gy = np.meshgrid(
                np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5
            )
            w0 = (
                (d1[0] - gx) * (d2[1] - gy) - (d2[0] - gx) * (d1[1] - gy)
            ) / area
            w1 = (
                (d2[0] - gx) * (d0[1] - gy) - (d0[0] - gx) * (d2[1] - gy)
            ) / area
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            r0, r1c, r2c = to_rgb(c0), to_rgb(c1), to_rgb(c2)
            col = (
                w0[..., None] * r0 + w1[..., None] * r1c + w2[..., None] * r2c
            )
            patch = overlay[y0:y1, x0:x1]
            patch[inside] = np.clip(col, 0, 255).astype(np.uint8)[inside]
            covered[y0:y1, x0:x1] |= inside
        cover = Image.fromarray(covered.astype(np.uint8) * 255, "L")
        if alpha < 1.0:
            cover = cover.point(lambda v: int(v * alpha))
        if mask is not None:
            cover = ImageChops.multiply(cover, mask)
        if clip is not None:
            cover = ImageChops.multiply(cover, clip)
        self.canvas.paste(Image.fromarray(overlay, "RGB"), (0, 0), cover)

    # -- main loop ------------------------------------------------------------

    def render(self) -> Image.Image:
        contents = self.doc.resolve(self.page.get("Contents"))
        chunks: List[bytes] = []
        if isinstance(contents, list):
            for c in contents:
                c = self.doc.resolve(c)
                if isinstance(c, StreamObj):
                    try:
                        chunks.append(c.decoded(self.doc))
                    except Exception:
                        pass
        elif isinstance(contents, StreamObj):
            try:
                chunks.append(contents.decoded(self.doc))
            except Exception:
                pass
        data = b"\n".join(chunks)
        self._execute(data, self._resources(self.page), GraphicsState(), depth=0)
        self._render_annotations()
        return self.canvas

    def _render_annotations(self) -> None:
        """Draw annotation /AP /N appearance streams (PDF 1.7 §12.5.5) —
        stamps, squares, form-field appearances. PyMuPDF's get_pixmap
        renders annotations by default (``/root/reference/dots_ocr/utils/
        doc_utils.py:20-39``), so pages carrying them differ without this.
        Hidden/NoView flags, Links, and Popups are skipped."""
        for ref in self.doc.resolve(self.page.get("Annots")) or []:
            a = self.doc.resolve(ref)
            if not isinstance(a, dict):
                continue
            flags = int(self.doc.resolve(a.get("F")) or 0)
            if flags & 0x2 or flags & 0x20:  # Hidden / NoView
                continue
            if a.get("Subtype") in (Name("Link"), Name("Popup")):
                continue
            ap = self.doc.resolve(a.get("AP"))
            n = self.doc.resolve(ap.get("N")) if isinstance(ap, dict) else None
            if isinstance(n, dict):  # state dict (checkboxes etc.)
                state = a.get("AS")
                pick = n.get(state) if state is not None else None
                if pick is None and n:
                    pick = next(iter(n.values()))
                n = self.doc.resolve(pick)
            if not isinstance(n, StreamObj):
                continue
            rect = [
                float(self.doc.resolve(v))
                for v in self.doc.resolve(a.get("Rect")) or []
            ]
            if len(rect) != 4:
                continue
            rx0, ry0 = min(rect[0], rect[2]), min(rect[1], rect[3])
            rx1, ry1 = max(rect[0], rect[2]), max(rect[1], rect[3])
            bbox = [
                float(self.doc.resolve(v))
                for v in self.doc.resolve(n.dict.get("BBox")) or [0, 0, 1, 1]
            ]
            fm = self.doc.resolve(n.dict.get("Matrix"))
            fmat = (
                tuple(float(self.doc.resolve(v)) for v in fm)
                if isinstance(fm, list) and len(fm) == 6 else IDENTITY
            )
            # §12.5.5: map the Matrix-transformed BBox onto Rect.
            corners = [
                mat_apply(fmat, x, y)
                for x, y in (
                    (bbox[0], bbox[1]), (bbox[2], bbox[1]),
                    (bbox[0], bbox[3]), (bbox[2], bbox[3]),
                )
            ]
            txs = [p[0] for p in corners]
            tys = [p[1] for p in corners]
            bw = (max(txs) - min(txs)) or 1.0
            bh = (max(tys) - min(tys)) or 1.0
            sx, sy = (rx1 - rx0) / bw, (ry1 - ry0) / bh
            gmap = mat_mul(
                fmat,
                (sx, 0.0, 0.0, sy, rx0 - min(txs) * sx, ry0 - min(tys) * sy),
            )
            res = self.doc.resolve(n.dict.get("Resources")) or self._resources(
                self.page
            )
            try:
                self._execute(
                    n.decoded(self.doc), res, GraphicsState(ctm=gmap), depth=1
                )
            except Exception:
                pass

    def _execute(self, data: bytes, resources: Dict[Name, Any], gs: GraphicsState, depth: int) -> None:
        if depth > 8:
            return
        stack: List[Any] = []
        gs_stack: List[GraphicsState] = []
        tm: Matrix = IDENTITY
        tlm: Matrix = IDENTITY
        # Path under construction: [user-space points, closed] per subpath
        # (mutable pairs so `h` can flip the closed flag in place).
        subpaths: List[List[Any]] = []
        cur_sub: Optional[List[Tuple[float, float]]] = None

        def start_sub(x: float, y: float) -> None:
            nonlocal cur_sub
            cur_sub = [(x, y)]
            subpaths.append([cur_sub, False])

        pending_clip = False  # W/W* seen; applies at the next paint op

        def paint(fill: bool, stroke: bool, close: bool = False) -> None:
            nonlocal subpaths, cur_sub, pending_clip
            if close and subpaths:
                subpaths[-1][1] = True
            painted = [(pts, closed) for pts, closed in subpaths if len(pts) >= 2]
            if painted and (fill or stroke):
                self._paint_path(painted, gs, fill, stroke)
            if pending_clip:
                # PDF 1.7 §8.5.4: the clip set by W/W* takes effect AFTER
                # this painting op (incl. the no-op `n` — the `re W n`
                # idiom), intersecting the current clip.
                mask = self._path_clip_mask(
                    [(pts, closed) for pts, closed in subpaths], gs.ctm
                )
                if mask is not None:
                    gs.clip = (
                        mask if gs.clip is None
                        else ImageChops.multiply(gs.clip, mask)
                    )
                pending_clip = False
            subpaths = []
            cur_sub = None

        def show_text(raw: bytes) -> None:
            nonlocal tm
            font = gs.font or LoadedFont()
            trm = mat_mul((gs.font_size * gs.h_scale, 0, 0, gs.font_size, 0, gs.rise), mat_mul(tm, gs.ctm))
            total = mat_mul(trm, self.base)
            # Effective pixel size of the glyphs: vertical scale of total.
            px = max(1, round(abs(total[3]) if abs(total[3]) > 1e-9 else abs(total[1])))
            # Glyph-ID rendering (Type0/Identity-H + embedded TrueType):
            # rasterize the ACTUAL glyph program (ingest/ttf.py) instead of
            # round-tripping through ToUnicode + PIL's cmap lookup — subset
            # fonts ship broken cmaps, which was the builtin backend's text
            # fidelity gap (PARITY.md). Simple 1-byte fonts with an embedded
            # Type 1 program render by GLYPH NAME through the PDF /Encoding
            # Differences (ingest/type1.py — the pdfTeX/Computer Modern
            # class); other simple fonts keep the PIL path (their codes
            # address the font's own encoding, which FreeType resolves
            # natively).
            use_glyphs = font.two_byte and font.truetype() is not None
            use_t1 = not font.two_byte and font.type1() is not None
            use_t3 = font.charprocs is not None
            pil_font = None  # loaded lazily on the first PIL-drawn glyph
            x_cursor = 0.0
            text_buf: List[Tuple[float, int, str]] = []
            for code, uni in font.decode(raw):
                if use_glyphs or use_t1 or use_t3 or uni:
                    text_buf.append((x_cursor, code, uni))
                w0 = font.width(code)
                adv = w0 * gs.font_size + gs.char_spacing
                if not font.two_byte and code == 32:
                    adv += gs.word_spacing
                x_cursor += adv * gs.h_scale
            # Draw each glyph/run at its device position (baseline
            # anchored). Under a clip, glyphs render into one "L" overlay
            # per show-text run and composite through the clip mask once.
            if gs.text_mode in (3, 7):
                # Invisible text (Tr 3 / clip-only 7): the searchable-scan
                # OCR layer — advance the text matrix, paint nothing.
                tm = mat_mul((1, 0, 0, 1, x_cursor, 0), tm)
                return
            m = mat_mul(tm, mat_mul(gs.ctm, self.base))
            overlay = odraw = None
            if (gs.clip is not None or gs.fill_alpha < 1.0) and text_buf:
                overlay = Image.new("L", self.canvas.size, 0)
                odraw = ImageDraw.Draw(overlay)
            for x_off, code, uni in text_buf:
                dx, dy = mat_apply(m, x_off, gs.rise)
                if use_t3:
                    # Type 3: the glyph IS a content stream, executed in
                    # glyph space: FontMatrix x [fs*Th 0 0 fs x_off rise]
                    # x Tm x CTM (PDF 1.7 §9.6.5). Inherits fill color and
                    # clip via the cloned state; depth-bounded like forms.
                    name = font.differences.get(code)
                    proc = font.charprocs.get(name) if name else None
                    if proc is not None:
                        inner = gs.clone()
                        inner.ctm = mat_mul(
                            font.font_matrix or (0.001, 0, 0, 0.001, 0, 0),
                            mat_mul(
                                (gs.font_size * gs.h_scale, 0, 0,
                                 gs.font_size, x_off, gs.rise),
                                mat_mul(tm, gs.ctm),
                            ),
                        )
                        try:
                            self._execute(
                                proc.decoded(self.doc),
                                font.t3_resources or resources,
                                inner,
                                depth + 1,
                            )
                        except Exception:
                            pass
                    continue
                bm = None
                if use_glyphs:
                    bm, xb, yt = font.glyph_bitmap(code, px)
                elif use_t1:
                    bm, xb, yt = font.t1_bitmap(code, px)
                if bm is not None:
                    mask = Image.fromarray(bm, "L")
                    pos = (int(round(dx + xb)), int(round(dy - yt)))
                    if overlay is not None:
                        overlay.paste(255, pos, mask)
                    else:
                        self.canvas.paste(gs.fill_rgb, pos, mask)
                    continue
                if use_glyphs or not uni:
                    continue  # no glyph program hit and nothing to draw
                if pil_font is None:
                    pil_font = font.pil_font(px)
                target, ink = (
                    (odraw, 255) if odraw is not None
                    else (self.draw, gs.fill_rgb)
                )
                try:
                    target.text((dx, dy), uni, font=pil_font, fill=ink, anchor="ls")
                except (ValueError, OSError):
                    target.text((dx, dy - px), uni, font=pil_font, fill=ink)
            if overlay is not None:
                if gs.fill_alpha < 1.0:
                    a = gs.fill_alpha
                    overlay = overlay.point(lambda v: int(v * a))
                if gs.clip is not None:
                    overlay = ImageChops.multiply(overlay, gs.clip)
                self.canvas.paste(gs.fill_rgb, (0, 0), overlay)
            # Advance the text matrix.
            tm = mat_mul((1, 0, 0, 1, x_cursor, 0), tm)

        for kind, tok in _tokenize_content(data):
            if kind == "val":
                stack.append(tok)
                continue
            if kind == "inline_image":
                d, payload = tok
                try:
                    img = decode_image_xobject(self.doc, StreamObj(d, payload))
                    if img is not None:
                        self._paste_image(img, gs.ctm, gs.fill_rgb,
                                          is_mask=bool(self.doc.resolve(d.get("IM") or d.get("ImageMask"))),
                                          clip=gs.clip, alpha=gs.fill_alpha)
                except Exception:
                    pass
                stack.clear()
                continue

            op = tok
            try:
                if op == "q":
                    gs_stack.append(gs.clone())
                elif op == "Q":
                    if gs_stack:
                        gs = gs_stack.pop()
                elif op == "cm" and len(stack) >= 6:
                    m = tuple(float(v) for v in stack[-6:])
                    gs.ctm = mat_mul(m, gs.ctm)  # type: ignore[arg-type]
                elif op == "gs" and stack:
                    # ExtGState: constant alpha (watermarks / highlight
                    # overlays) + line width; other entries are ignored.
                    egs = self.doc.resolve(resources.get("ExtGState")) or {}
                    g2 = self.doc.resolve(egs.get(Name(str(stack[-1]))))
                    if isinstance(g2, dict):
                        ca = self.doc.resolve(g2.get("ca"))
                        if isinstance(ca, (int, float)):
                            gs.fill_alpha = float(ca)
                        CA = self.doc.resolve(g2.get("CA"))
                        if isinstance(CA, (int, float)):
                            gs.stroke_alpha = float(CA)
                        lw = self.doc.resolve(g2.get("LW"))
                        if isinstance(lw, (int, float)):
                            gs.line_width = float(lw)
                elif op == "Do" and stack:
                    name = stack[-1]
                    xobjects = self.doc.resolve(resources.get("XObject")) or {}
                    xobj = self.doc.resolve(xobjects.get(Name(str(name))))
                    if isinstance(xobj, StreamObj):
                        subtype = xobj.dict.get("Subtype")
                        if subtype == Name("Image"):
                            img = decode_image_xobject(self.doc, xobj)
                            if img is not None:
                                self._paste_image(
                                    img, gs.ctm, gs.fill_rgb,
                                    is_mask=bool(self.doc.resolve(xobj.dict.get("ImageMask"))),
                                    clip=gs.clip,
                                    alpha=gs.fill_alpha,
                                )
                        elif subtype == Name("Form"):
                            inner = gs.clone()
                            fm = self.doc.resolve(xobj.dict.get("Matrix"))
                            if isinstance(fm, list) and len(fm) == 6:
                                inner.ctm = mat_mul(tuple(float(v) for v in fm), inner.ctm)  # type: ignore[arg-type]
                            # Forms clip to their /BBox (PDF 1.7 §8.10.1).
                            fb = self.doc.resolve(xobj.dict.get("BBox"))
                            if isinstance(fb, list) and len(fb) == 4:
                                bx = [float(self.doc.resolve(v)) for v in fb]
                                x0b, x1b = sorted((bx[0], bx[2]))
                                y0b, y1b = sorted((bx[1], bx[3]))
                                bb_mask = self._path_clip_mask(
                                    [([(x0b, y0b), (x1b, y0b),
                                       (x1b, y1b), (x0b, y1b)], True)],
                                    inner.ctm,
                                )
                                if bb_mask is not None:
                                    inner.clip = (
                                        bb_mask if inner.clip is None
                                        else ImageChops.multiply(
                                            inner.clip, bb_mask
                                        )
                                    )
                            form_res = self.doc.resolve(xobj.dict.get("Resources")) or resources
                            try:
                                self._execute(xobj.decoded(self.doc), form_res, inner, depth + 1)
                            except Exception:
                                pass
                # Color (track fill color for text/masks/rects)
                elif op == "g" and stack:
                    v = int(float(stack[-1]) * 255)
                    gs.fill_rgb = (v, v, v)
                    gs.fill_shading = gs.fill_tiling = None
                elif op == "rg" and len(stack) >= 3:
                    gs.fill_rgb = tuple(int(float(v) * 255) for v in stack[-3:])  # type: ignore[assignment]
                    gs.fill_shading = gs.fill_tiling = None
                elif op == "k" and len(stack) >= 4:
                    cc, mm, yy, kk = (float(v) for v in stack[-4:])
                    gs.fill_rgb = (
                        int(255 * (1 - min(1.0, cc + kk))),
                        int(255 * (1 - min(1.0, mm + kk))),
                        int(255 * (1 - min(1.0, yy + kk))),
                    )
                    gs.fill_shading = gs.fill_tiling = None
                elif op in ("sc", "scn") and stack:
                    if op == "scn" and isinstance(stack[-1], Name):
                        # /Name scn in a /Pattern space: PatternType 2
                        # (shading) patterns paint a gradient and
                        # PatternType 1 (tiling) patterns repeat their
                        # cell through subsequent fills.
                        pats = self.doc.resolve(resources.get("Pattern")) or {}
                        pat = self.doc.resolve(pats.get(Name(str(stack[-1]))))
                        pd = pat.dict if isinstance(pat, StreamObj) else pat
                        gs.fill_shading = None
                        gs.fill_tiling = None
                        if isinstance(pd, dict):
                            pm = self.doc.resolve(pd.get("Matrix"))
                            pmat = (
                                tuple(float(self.doc.resolve(v)) for v in pm)
                                if isinstance(pm, list) and len(pm) == 6
                                else IDENTITY
                            )
                            ptype = int(
                                self.doc.resolve(pd.get("PatternType")) or 0
                            )
                            if ptype == 2:
                                gs.fill_shading = (
                                    self.doc.resolve(pd.get("Shading")), pmat
                                )
                            elif ptype == 1 and isinstance(pat, StreamObj):
                                gs.fill_tiling = (pat, pmat)
                    else:
                        nums = [v for v in stack if isinstance(v, (int, float))]
                        if len(nums) >= 3:
                            gs.fill_rgb = tuple(int(float(v) * 255) for v in nums[-3:])  # type: ignore[assignment]
                            gs.fill_shading = gs.fill_tiling = None
                        elif len(nums) == 1:
                            v = int(float(nums[0]) * 255)
                            gs.fill_rgb = (v, v, v)
                            gs.fill_shading = gs.fill_tiling = None
                elif op == "sh" and stack:
                    # Direct shading paint: covers the clip region (PDF
                    # 1.7 §8.7.4.2), coords in CURRENT user space.
                    shs = self.doc.resolve(resources.get("Shading")) or {}
                    sh_obj = self.doc.resolve(shs.get(Name(str(stack[-1]))))
                    if sh_obj is not None:
                        self._paint_shading(
                            sh_obj, mat_mul(gs.ctm, self.base), gs.clip,
                            alpha=gs.fill_alpha,
                        )
                elif op == "G" and stack:
                    v = int(float(stack[-1]) * 255)
                    gs.stroke_rgb = (v, v, v)
                elif op == "RG" and len(stack) >= 3:
                    gs.stroke_rgb = tuple(int(float(v) * 255) for v in stack[-3:])  # type: ignore[assignment]
                elif op == "K" and len(stack) >= 4:
                    cc, mm, yy, kk = (float(v) for v in stack[-4:])
                    gs.stroke_rgb = (
                        int(255 * (1 - min(1.0, cc + kk))),
                        int(255 * (1 - min(1.0, mm + kk))),
                        int(255 * (1 - min(1.0, yy + kk))),
                    )
                elif op in ("SC", "SCN") and stack:
                    nums = [v for v in stack if isinstance(v, (int, float))]
                    if len(nums) >= 3:
                        gs.stroke_rgb = tuple(int(float(v) * 255) for v in nums[-3:])  # type: ignore[assignment]
                    elif len(nums) == 1:
                        v = int(float(nums[0]) * 255)
                        gs.stroke_rgb = (v, v, v)
                # Path construction (PDF 1.7 §8.5.2): full operator set with
                # cubic Beziers flattened to polylines.
                elif op == "m" and len(stack) >= 2:
                    start_sub(float(stack[-2]), float(stack[-1]))
                elif op == "l" and len(stack) >= 2:
                    if cur_sub is None:
                        start_sub(float(stack[-2]), float(stack[-1]))
                    else:
                        cur_sub.append((float(stack[-2]), float(stack[-1])))
                elif op in ("c", "v", "y") and cur_sub is not None:
                    p0 = cur_sub[-1]
                    if op == "c" and len(stack) >= 6:
                        x1, y1, x2, y2, x3, y3 = (float(v) for v in stack[-6:])
                    elif op == "v" and len(stack) >= 4:
                        x2, y2, x3, y3 = (float(v) for v in stack[-4:])
                        x1, y1 = p0
                    elif op == "y" and len(stack) >= 4:
                        x1, y1, x3, y3 = (float(v) for v in stack[-4:])
                        x2, y2 = x3, y3
                    else:
                        stack.clear()
                        continue
                    cur_sub.extend(_flatten_cubic(p0, (x1, y1), (x2, y2), (x3, y3)))
                elif op == "h":
                    if subpaths:
                        subpaths[-1][1] = True
                    if cur_sub:
                        cur_sub = None  # next segment op starts a new subpath
                elif op == "re" and len(stack) >= 4:
                    x, y, w, h = (float(v) for v in stack[-4:])
                    start_sub(x, y)
                    assert cur_sub is not None
                    cur_sub.extend([(x + w, y), (x + w, y + h), (x, y + h)])
                    subpaths[-1][1] = True
                    cur_sub = None
                # Path painting
                elif op in ("f", "F", "f*"):
                    paint(fill=True, stroke=False)
                elif op in ("B", "B*"):
                    paint(fill=True, stroke=True)
                elif op in ("b", "b*"):
                    paint(fill=True, stroke=True, close=True)
                elif op == "S":
                    paint(fill=False, stroke=True)
                elif op == "s":
                    paint(fill=False, stroke=True, close=True)
                elif op == "n":
                    paint(fill=False, stroke=False)
                elif op in ("W", "W*"):
                    pending_clip = True
                elif op == "w" and stack:
                    gs.line_width = float(stack[-1])
                # Text
                elif op == "BT":
                    tm = IDENTITY
                    tlm = IDENTITY
                elif op == "ET":
                    pass
                elif op == "Tf" and len(stack) >= 2:
                    gs.font = self._get_font(resources, str(stack[-2]))
                    gs.font_size = float(stack[-1])
                elif op == "Td" and len(stack) >= 2:
                    tlm = mat_mul((1, 0, 0, 1, float(stack[-2]), float(stack[-1])), tlm)
                    tm = tlm
                elif op == "TD" and len(stack) >= 2:
                    gs.leading = -float(stack[-1])
                    tlm = mat_mul((1, 0, 0, 1, float(stack[-2]), float(stack[-1])), tlm)
                    tm = tlm
                elif op == "Tm" and len(stack) >= 6:
                    tlm = tuple(float(v) for v in stack[-6:])  # type: ignore[assignment]
                    tm = tlm
                elif op == "T*":
                    tlm = mat_mul((1, 0, 0, 1, 0, -gs.leading), tlm)
                    tm = tlm
                elif op == "TL" and stack:
                    gs.leading = float(stack[-1])
                elif op == "Tc" and stack:
                    gs.char_spacing = float(stack[-1])
                elif op == "Tw" and stack:
                    gs.word_spacing = float(stack[-1])
                elif op == "Tz" and stack:
                    gs.h_scale = float(stack[-1]) / 100.0
                elif op == "Tr" and stack:
                    gs.text_mode = int(float(stack[-1]))
                elif op == "Ts" and stack:
                    gs.rise = float(stack[-1])
                elif op == "Tj" and stack:
                    if isinstance(stack[-1], bytes):
                        show_text(stack[-1])
                elif op == "'" and stack:
                    tlm = mat_mul((1, 0, 0, 1, 0, -gs.leading), tlm)
                    tm = tlm
                    if isinstance(stack[-1], bytes):
                        show_text(stack[-1])
                elif op == '"' and len(stack) >= 3:
                    gs.word_spacing = float(stack[-3])
                    gs.char_spacing = float(stack[-2])
                    tlm = mat_mul((1, 0, 0, 1, 0, -gs.leading), tlm)
                    tm = tlm
                    if isinstance(stack[-1], bytes):
                        show_text(stack[-1])
                elif op == "TJ" and stack and isinstance(stack[-1], list):
                    for item in stack[-1]:
                        if isinstance(item, bytes):
                            show_text(item)
                        elif isinstance(item, (int, float)):
                            shift = -float(item) / 1000.0 * gs.font_size * gs.h_scale
                            tm = mat_mul((1, 0, 0, 1, shift, 0), tm)
            except Exception:
                pass
            stack.clear()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def open_pdf(source) -> PDFDocument:
    """Open a PDF from a path, bytes, or file-like object."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    elif hasattr(source, "read"):
        data = source.read()
    else:
        with open(source, "rb") as f:
            data = f.read()
    return PDFDocument(data)


def render_page(doc: PDFDocument, page_index: int, dpi: float = 72.0) -> Image.Image:
    pages = doc.pages()
    if not 0 <= page_index < len(pages):
        raise IndexError(f"page {page_index} out of range ({len(pages)} pages)")
    return PageRasterizer(doc, pages[page_index], dpi=dpi).render()
