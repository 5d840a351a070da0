"""SVG output evaluation: render model-generated SVG and score it against
the source image.

Reference parity: the reference evaluates its image→SVG task (prompt
``prompt_image_to_svg``, ``dots_ocr/utils/prompts.py:38``) by rasterizing
model output with cairosvg (``reference/requirements.txt:12``) and
scoring image similarity — the UniSVG / ChartMimic rows in the README
(``reference/README.md:447-467``). This module is the rebuild's
equivalent: :func:`render_svg` rasterizes (cairosvg when installed, else a
from-scratch bounded renderer below) and :func:`score_svg` computes the
similarity metrics.

Metric drift note: UniSVG's published composite also includes CLIP-space
similarity, which needs a vision model unavailable offline. The in-repo
score is pixel-space only (SSIM + color L1) — comparable across runs of
THIS harness, not numerically identical to the published 0.902
(BASELINE.md UniSVG row). Documented here per SURVEY §6.

The built-in renderer is deliberately bounded against hostile/degenerate
model output (the SVG task decodes up to 16k tokens at temperature 0.9 —
loops and garbage happen, SURVEY §5.7): no external entities, canvas and
element-count caps, and per-path point budgets. It reuses the affine and
Bezier machinery from ``ingest/minipdf.py`` (the from-scratch PDF
rasterizer) rather than growing a second implementation.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from PIL import Image, ImageDraw

from dots_ocr_tpu_torch.ingest.minipdf import (
    Matrix,
    _flatten_cubic,
    mat_apply,
    mat_mul,
)

IDENTITY: Matrix = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)

# Hard bounds against hostile / degenerate model output.
MAX_CANVAS_PX = 4096 * 4096
MAX_ELEMENTS = 10_000
MAX_PATH_POINTS = 500_000
MAX_SVG_BYTES = 4 * 1024 * 1024

__all__ = ["render_svg", "score_svg", "extract_svg", "SVGRenderError"]


class SVGRenderError(ValueError):
    """Raised when SVG text cannot be rendered (unparseable / over budget)."""


# --------------------------------------------------------------------------
# Color parsing (CSS basic color keywords + hex + rgb()).
# --------------------------------------------------------------------------

_NAMED_COLORS = {
    "black": (0, 0, 0), "white": (255, 255, 255), "red": (255, 0, 0),
    "green": (0, 128, 0), "blue": (0, 0, 255), "yellow": (255, 255, 0),
    "cyan": (0, 255, 255), "aqua": (0, 255, 255), "magenta": (255, 0, 255),
    "fuchsia": (255, 0, 255), "gray": (128, 128, 128),
    "grey": (128, 128, 128), "silver": (192, 192, 192),
    "maroon": (128, 0, 0), "olive": (128, 128, 0), "lime": (0, 255, 0),
    "teal": (0, 128, 128), "navy": (0, 0, 128), "purple": (128, 0, 128),
    "orange": (255, 165, 0), "pink": (255, 192, 203),
    "brown": (165, 42, 42), "gold": (255, 215, 0),
    "lightgray": (211, 211, 211), "lightgrey": (211, 211, 211),
    "darkgray": (169, 169, 169), "darkgrey": (169, 169, 169),
    "lightblue": (173, 216, 230), "lightgreen": (144, 238, 144),
    "darkblue": (0, 0, 139), "darkgreen": (0, 100, 0),
    "darkred": (139, 0, 0), "beige": (245, 245, 220),
    "ivory": (255, 255, 240), "tan": (210, 180, 140),
    "skyblue": (135, 206, 235), "steelblue": (70, 130, 180),
    "tomato": (255, 99, 71), "coral": (255, 127, 80),
    "salmon": (250, 128, 114), "khaki": (240, 230, 140),
    "lavender": (230, 230, 250), "plum": (221, 160, 221),
    "orchid": (218, 112, 214), "crimson": (220, 20, 60),
    "indigo": (75, 0, 130), "violet": (238, 130, 238),
    "turquoise": (64, 224, 208), "royalblue": (65, 105, 225),
    "slategray": (112, 128, 144), "slategrey": (112, 128, 144),
    "dimgray": (105, 105, 105), "dimgrey": (105, 105, 105),
    "gainsboro": (220, 220, 220), "whitesmoke": (245, 245, 245),
    "transparent": None, "none": None,
}


def _parse_color(value: Optional[str]) -> Optional[Tuple[int, int, int]]:
    """CSS color → RGB tuple, or None for none/transparent/unsupported."""
    if value is None:
        return None
    v = value.strip().lower()
    if not v:
        return None
    if v.startswith("#"):
        h = v[1:]
        try:
            if len(h) == 3:
                return tuple(int(c * 2, 16) for c in h)  # type: ignore
            if len(h) == 6:
                return (int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16))
        except ValueError:
            return None
        return None
    m = re.match(r"rgba?\(([^)]*)\)", v)
    if m:
        parts = [p.strip() for p in m.group(1).split(",")]
        if len(parts) >= 3:
            try:
                rgb = []
                for p in parts[:3]:
                    if p.endswith("%"):
                        rgb.append(int(round(float(p[:-1]) * 2.55)))
                    else:
                        rgb.append(int(round(float(p))))
                return tuple(max(0, min(255, c)) for c in rgb)  # type: ignore
            except ValueError:
                return None
        return None
    if v.startswith("url("):  # gradients/patterns: approximate mid-gray
        return (128, 128, 128)
    return _NAMED_COLORS.get(v, (0, 0, 0) if v == "currentcolor" else None)


def _parse_length(value: Optional[str], default: float = 0.0,
                  ref: float = 0.0) -> float:
    """SVG length → user units (px). Percentages resolve against ``ref``."""
    if value is None:
        return default
    v = str(value).strip()
    if not v:
        return default
    try:
        if v.endswith("%"):
            return float(v[:-1]) / 100.0 * ref
        m = re.match(r"^([+-]?[0-9.eE+-]+)\s*(px|pt|mm|cm|in|em)?$", v)
        if not m:
            return default
        num = float(m.group(1))
        unit = m.group(2)
        scale = {"pt": 96 / 72, "mm": 96 / 25.4, "cm": 96 / 2.54,
                 "in": 96.0, "em": 16.0}.get(unit or "px", 1.0)
        return num * scale
    except (ValueError, OverflowError):
        return default


# --------------------------------------------------------------------------
# Transform parsing.
# --------------------------------------------------------------------------

_TRANSFORM_RE = re.compile(r"(matrix|translate|scale|rotate|skewX|skewY)"
                           r"\s*\(([^)]*)\)")


def _parse_transform(text: Optional[str]) -> Matrix:
    """SVG ``transform`` attribute → row-vector affine matrix."""
    if not text:
        return IDENTITY
    m = IDENTITY
    for name, args in _TRANSFORM_RE.findall(text):
        try:
            vals = [float(x) for x in re.split(r"[,\s]+", args.strip()) if x]
        except ValueError:
            continue
        # SVG matrices are column-vector (a b c d e f); our convention is
        # row-vector p' = p @ M, so the same six numbers slot straight in.
        if name == "matrix" and len(vals) == 6:
            t: Matrix = tuple(vals)  # type: ignore
        elif name == "translate":
            tx = vals[0] if vals else 0.0
            ty = vals[1] if len(vals) > 1 else 0.0
            t = (1, 0, 0, 1, tx, ty)
        elif name == "scale":
            sx = vals[0] if vals else 1.0
            sy = vals[1] if len(vals) > 1 else sx
            t = (sx, 0, 0, sy, 0, 0)
        elif name == "rotate":
            a = math.radians(vals[0]) if vals else 0.0
            ca, sa = math.cos(a), math.sin(a)
            t = (ca, sa, -sa, ca, 0, 0)
            if len(vals) >= 3:
                cx, cy = vals[1], vals[2]
                t = mat_mul(mat_mul((1, 0, 0, 1, -cx, -cy), t),
                            (1, 0, 0, 1, cx, cy))
        elif name == "skewX" and vals:
            t = (1, 0, math.tan(math.radians(vals[0])), 1, 0, 0)
        elif name == "skewY" and vals:
            t = (1, math.tan(math.radians(vals[0])), 0, 1, 0, 0)
        else:
            continue
        m = mat_mul(t, m)
    return m


# --------------------------------------------------------------------------
# Path data parsing (SVG 1.1 §8.3) → flattened subpaths.
# --------------------------------------------------------------------------

_PATH_TOKEN_RE = re.compile(
    r"([MmLlHhVvCcSsQqTtAaZz])|([+-]?(?:\d*\.\d+|\d+\.?)(?:[eE][+-]?\d+)?)"
)


def _arc_to_points(x1, y1, rx, ry, phi_deg, large, sweep, x2, y2,
                   steps: int = 24) -> List[Tuple[float, float]]:
    """Endpoint-parameterized elliptical arc → polyline (SVG impl. notes
    B.2.4: endpoint→center conversion, then uniform angle subdivision)."""
    if rx == 0 or ry == 0 or (x1 == x2 and y1 == y2):
        return [(x2, y2)]
    rx, ry = abs(rx), abs(ry)
    phi = math.radians(phi_deg % 360.0)
    cp, sp = math.cos(phi), math.sin(phi)
    dx, dy = (x1 - x2) / 2.0, (y1 - y2) / 2.0
    x1p = cp * dx + sp * dy
    y1p = -sp * dx + cp * dy
    lam = (x1p / rx) ** 2 + (y1p / ry) ** 2
    if lam > 1.0:
        s = math.sqrt(lam)
        rx, ry = rx * s, ry * s
    num = rx * rx * ry * ry - rx * rx * y1p * y1p - ry * ry * x1p * x1p
    den = rx * rx * y1p * y1p + ry * ry * x1p * x1p
    coef = math.sqrt(max(0.0, num / den)) if den else 0.0
    if large == sweep:
        coef = -coef
    cxp = coef * rx * y1p / ry
    cyp = -coef * ry * x1p / rx
    cx = cp * cxp - sp * cyp + (x1 + x2) / 2.0
    cy = sp * cxp + cp * cyp + (y1 + y2) / 2.0

    def angle(ux, uy, vx, vy):
        dot = ux * vx + uy * vy
        n = math.hypot(ux, uy) * math.hypot(vx, vy)
        a = math.acos(max(-1.0, min(1.0, dot / n))) if n else 0.0
        return -a if ux * vy - uy * vx < 0 else a

    th1 = angle(1, 0, (x1p - cxp) / rx, (y1p - cyp) / ry)
    dth = angle((x1p - cxp) / rx, (y1p - cyp) / ry,
                (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not sweep and dth > 0:
        dth -= 2 * math.pi
    elif sweep and dth < 0:
        dth += 2 * math.pi
    out = []
    for i in range(1, steps + 1):
        th = th1 + dth * i / steps
        xe = cx + rx * math.cos(th) * cp - ry * math.sin(th) * sp
        ye = cy + rx * math.cos(th) * sp + ry * math.sin(th) * cp
        out.append((xe, ye))
    out[-1] = (x2, y2)
    return out


def _parse_path(d: str, budget: List[int]) -> List[Tuple[List[Tuple[float, float]], bool]]:
    """Path data → list of (points, closed) subpaths, curves flattened."""
    tokens: List = []
    for m in _PATH_TOKEN_RE.finditer(d):
        if m.group(1):
            tokens.append(m.group(1))
        else:
            try:
                tokens.append(float(m.group(2)))
            except ValueError:
                return []
    subpaths: List[Tuple[List[Tuple[float, float]], bool]] = []
    pts: List[Tuple[float, float]] = []
    cx = cy = sx = sy = 0.0
    pcx: Optional[Tuple[float, float]] = None  # previous cubic control
    pqx: Optional[Tuple[float, float]] = None  # previous quadratic control
    i = 0
    cmd = ""

    def nums(n: int) -> Optional[List[float]]:
        nonlocal i
        if i + n > len(tokens):
            return None
        vals = tokens[i:i + n]
        if any(isinstance(v, str) for v in vals):
            return None
        i += n
        return vals  # type: ignore

    def flush(closed: bool) -> None:
        nonlocal pts
        if len(pts) >= 2:
            subpaths.append((pts, closed))
        pts = []

    while i < len(tokens):
        if isinstance(tokens[i], str):
            cmd = tokens[i]
            i += 1
        elif not cmd:
            break
        elif cmd == "M":
            cmd = "L"
        elif cmd == "m":
            cmd = "l"
        rel = cmd.islower()
        c = cmd.upper()
        if c == "Z":
            if pts:
                cx, cy = sx, sy
            flush(True)
            pts = [(cx, cy)]
            pcx = pqx = None
            continue
        if c == "M":
            v = nums(2)
            if v is None:
                break
            flush(False)
            cx = cx + v[0] if rel else v[0]
            cy = cy + v[1] if rel else v[1]
            sx, sy = cx, cy
            pts = [(cx, cy)]
            pcx = pqx = None
            continue
        if c in ("L", "H", "V"):
            if c == "L":
                v = nums(2)
                if v is None:
                    break
                nx = cx + v[0] if rel else v[0]
                ny = cy + v[1] if rel else v[1]
            elif c == "H":
                v = nums(1)
                if v is None:
                    break
                nx = cx + v[0] if rel else v[0]
                ny = cy
            else:
                v = nums(1)
                if v is None:
                    break
                nx = cx
                ny = cy + v[0] if rel else v[0]
            if not pts:
                pts = [(cx, cy)]
            pts.append((nx, ny))
            cx, cy = nx, ny
            pcx = pqx = None
        elif c in ("C", "S"):
            if c == "C":
                v = nums(6)
                if v is None:
                    break
                x1, y1, x2, y2, x3, y3 = v
            else:
                v = nums(4)
                if v is None:
                    break
                x2, y2, x3, y3 = v
                if rel:
                    rx1 = (2 * cx - pcx[0] - cx, 2 * cy - pcx[1] - cy) \
                        if pcx else (0.0, 0.0)
                    x1, y1 = rx1
                else:
                    x1, y1 = (2 * cx - pcx[0], 2 * cy - pcx[1]) \
                        if pcx else (cx, cy)
            if rel:
                x1, y1, x2, y2, x3, y3 = (cx + x1, cy + y1, cx + x2,
                                          cy + y2, cx + x3, cy + y3)
            if not pts:
                pts = [(cx, cy)]
            pts.extend(_flatten_cubic((cx, cy), (x1, y1), (x2, y2), (x3, y3)))
            pcx, pqx = (x2, y2), None
            cx, cy = x3, y3
        elif c in ("Q", "T"):
            if c == "Q":
                v = nums(4)
                if v is None:
                    break
                x1, y1, x3, y3 = v
                if rel:
                    x1, y1, x3, y3 = cx + x1, cy + y1, cx + x3, cy + y3
            else:
                v = nums(2)
                if v is None:
                    break
                x3, y3 = v
                if rel:
                    x3, y3 = cx + x3, cy + y3
                x1, y1 = (2 * cx - pqx[0], 2 * cy - pqx[1]) if pqx else (cx, cy)
            # quadratic → cubic elevation
            c1 = (cx + 2.0 / 3.0 * (x1 - cx), cy + 2.0 / 3.0 * (y1 - cy))
            c2 = (x3 + 2.0 / 3.0 * (x1 - x3), y3 + 2.0 / 3.0 * (y1 - y3))
            if not pts:
                pts = [(cx, cy)]
            pts.extend(_flatten_cubic((cx, cy), c1, c2, (x3, y3)))
            pqx, pcx = (x1, y1), None
            cx, cy = x3, y3
        elif c == "A":
            v = nums(7)
            if v is None:
                break
            rx_, ry_, rot, large, sweep, x3, y3 = v
            if rel:
                x3, y3 = cx + x3, cy + y3
            if not pts:
                pts = [(cx, cy)]
            pts.extend(_arc_to_points(cx, cy, rx_, ry_, rot,
                                      bool(large), bool(sweep), x3, y3))
            cx, cy = x3, y3
            pcx = pqx = None
        else:
            break
        budget[0] += len(pts)
        if budget[0] > MAX_PATH_POINTS:
            raise SVGRenderError("path point budget exceeded")
    flush(False)
    return subpaths


# --------------------------------------------------------------------------
# The renderer.
# --------------------------------------------------------------------------

_TAG_RE = re.compile(r"\{[^}]*\}")


def _local(tag) -> str:
    return _TAG_RE.sub("", tag) if isinstance(tag, str) else ""


def _style_dict(el: ET.Element) -> Dict[str, str]:
    """Merge presentation attributes and the style attribute (style wins)."""
    out = {k: v for k, v in el.attrib.items() if ":" not in k}
    style = el.get("style")
    if style:
        for part in style.split(";"):
            if ":" in part:
                k, v = part.split(":", 1)
                out[k.strip()] = v.strip()
    return out


class _SVGRasterizer:
    """Bounded from-scratch SVG renderer onto a PIL canvas.

    Supports the subset model-generated document/figure SVG actually uses:
    shapes (rect/circle/ellipse/line/polyline/polygon/path), groups with
    inherited presentation attributes and transforms, solid fills/strokes
    with opacity, and best-effort text via PIL's scalable default font.
    Gradients degrade to mid-gray; unknown elements are skipped.
    """

    _INHERITED = ("fill", "stroke", "stroke-width", "opacity",
                  "fill-opacity", "stroke-opacity", "font-size",
                  "text-anchor", "font-family")

    def __init__(self, root: ET.Element,
                 out_size: Optional[Tuple[int, int]] = None):
        st = _style_dict(root)
        vb = root.get("viewBox")
        if vb:
            try:
                parts = [float(x) for x in re.split(r"[,\s]+", vb.strip()) if x]
            except ValueError:
                parts = []
            if len(parts) == 4 and parts[2] > 0 and parts[3] > 0:
                self.vb = parts
            else:
                self.vb = [0.0, 0.0, 512.0, 512.0]
        else:
            w = _parse_length(st.get("width"), 0.0)
            h = _parse_length(st.get("height"), 0.0)
            self.vb = [0.0, 0.0, w or 512.0, h or 512.0]
        if out_size is not None:
            width, height = out_size
        else:
            width = int(round(_parse_length(st.get("width"), self.vb[2],
                                            ref=self.vb[2])))
            height = int(round(_parse_length(st.get("height"), self.vb[3],
                                             ref=self.vb[3])))
            width = width or int(round(self.vb[2]))
            height = height or int(round(self.vb[3]))
        width, height = max(1, width), max(1, height)
        if width * height > MAX_CANVAS_PX:
            scale = math.sqrt(MAX_CANVAS_PX / (width * height))
            width = max(1, int(width * scale))
            height = max(1, int(height * scale))
        self.size = (width, height)
        # viewBox → pixel transform (preserveAspectRatio=none semantics;
        # model output fills its own viewBox so letterboxing never helps).
        sx = width / self.vb[2]
        sy = height / self.vb[3]
        self.base: Matrix = (sx, 0.0, 0.0, sy,
                             -self.vb[0] * sx, -self.vb[1] * sy)
        self.canvas = Image.new("RGB", self.size, (255, 255, 255))
        self.draw = ImageDraw.Draw(self.canvas, "RGBA")
        self.elements = 0
        self.point_budget = [0]
        self.root = root

    def run(self) -> Image.Image:
        defaults = {"fill": "black", "stroke": "none", "stroke-width": "1",
                    "opacity": "1", "fill-opacity": "1",
                    "stroke-opacity": "1", "font-size": "16",
                    "text-anchor": "start"}
        self._walk(self.root, IDENTITY, defaults)
        return self.canvas

    # -- traversal ---------------------------------------------------------

    def _walk(self, el: ET.Element, ctm: Matrix, inherited: Dict[str, str]) -> None:
        self.elements += 1
        if self.elements > MAX_ELEMENTS:
            raise SVGRenderError("element budget exceeded")
        tag = _local(el.tag)
        st = _style_dict(el)
        props = dict(inherited)
        for k in self._INHERITED:
            if k in st:
                props[k] = st[k]
        ctm = mat_mul(_parse_transform(st.get("transform")), ctm)
        if tag in ("defs", "symbol", "clipPath", "mask", "marker",
                   "linearGradient", "radialGradient", "pattern", "style",
                   "metadata", "title", "desc", "script"):
            return
        if tag in ("svg", "g", "a"):
            for child in list(el):
                self._walk(child, ctm, props)
            return
        if tag == "use":
            return  # id-indirection: out of subset
        handler = getattr(self, f"_el_{tag}", None)
        if handler is not None:
            handler(el, st, ctm, props)

    # -- paint helpers ------------------------------------------------------

    def _paint(self, subpaths, ctm: Matrix, st: Dict[str, str],
               props: Dict[str, str], closed_default: bool) -> None:
        m = mat_mul(ctm, self.base)
        fill = _parse_color(st.get("fill", props.get("fill", "black")))
        stroke = _parse_color(st.get("stroke", props.get("stroke", "none")))
        op = _parse_length(props.get("opacity", "1"), 1.0)
        fop = op * _parse_length(props.get("fill-opacity", "1"), 1.0)
        sop = op * _parse_length(props.get("stroke-opacity", "1"), 1.0)
        sw = _parse_length(st.get("stroke-width",
                                  props.get("stroke-width", "1")), 1.0)
        a, b, c, d, _, _ = m
        scale = math.sqrt(abs(a * d - b * c)) or 1.0
        width = max(1, round(sw * scale))
        for pts, closed in subpaths:
            device = [mat_apply(m, x, y) for x, y in pts]
            if fill is not None and fop > 0 and len(device) >= 3:
                alpha = max(0, min(255, int(round(fop * 255))))
                self.draw.polygon(device, fill=fill + (alpha,))
            if stroke is not None and sop > 0 and len(device) >= 2:
                alpha = max(0, min(255, int(round(sop * 255))))
                line = device + device[:1] if (closed or closed_default) \
                    else device
                self.draw.line(line, fill=stroke + (alpha,), width=width)

    # -- element handlers ----------------------------------------------------

    def _el_rect(self, el, st, ctm, props) -> None:
        x = _parse_length(st.get("x"), 0.0, self.vb[2])
        y = _parse_length(st.get("y"), 0.0, self.vb[3])
        w = _parse_length(st.get("width"), 0.0, self.vb[2])
        h = _parse_length(st.get("height"), 0.0, self.vb[3])
        if w <= 0 or h <= 0:
            return
        pts = [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]
        self._paint([(pts, True)], ctm, st, props, True)

    def _el_circle(self, el, st, ctm, props) -> None:
        cx = _parse_length(st.get("cx"), 0.0, self.vb[2])
        cy = _parse_length(st.get("cy"), 0.0, self.vb[3])
        r = _parse_length(st.get("r"), 0.0, self.vb[2])
        if r <= 0:
            return
        pts = [(cx + r * math.cos(t * math.tau / 48),
                cy + r * math.sin(t * math.tau / 48)) for t in range(48)]
        self._paint([(pts, True)], ctm, st, props, True)

    def _el_ellipse(self, el, st, ctm, props) -> None:
        cx = _parse_length(st.get("cx"), 0.0, self.vb[2])
        cy = _parse_length(st.get("cy"), 0.0, self.vb[3])
        rx = _parse_length(st.get("rx"), 0.0, self.vb[2])
        ry = _parse_length(st.get("ry"), 0.0, self.vb[3])
        if rx <= 0 or ry <= 0:
            return
        pts = [(cx + rx * math.cos(t * math.tau / 48),
                cy + ry * math.sin(t * math.tau / 48)) for t in range(48)]
        self._paint([(pts, True)], ctm, st, props, True)

    def _el_line(self, el, st, ctm, props) -> None:
        pts = [(_parse_length(st.get("x1"), 0.0, self.vb[2]),
                _parse_length(st.get("y1"), 0.0, self.vb[3])),
               (_parse_length(st.get("x2"), 0.0, self.vb[2]),
                _parse_length(st.get("y2"), 0.0, self.vb[3]))]
        st = dict(st)
        st.setdefault("fill", "none")
        if st.get("stroke", props.get("stroke", "none")) in (None, "none"):
            st["stroke"] = "black"  # a line with no stroke paints nothing
        self._paint([(pts, False)], ctm, st, props, False)

    def _poly_points(self, st) -> List[Tuple[float, float]]:
        raw = st.get("points", "")
        try:
            vals = [float(x) for x in re.split(r"[,\s]+", raw.strip()) if x]
        except ValueError:
            return []
        return list(zip(vals[0::2], vals[1::2]))

    def _el_polyline(self, el, st, ctm, props) -> None:
        pts = self._poly_points(st)
        if len(pts) >= 2:
            self._paint([(pts, False)], ctm, st, props, False)

    def _el_polygon(self, el, st, ctm, props) -> None:
        pts = self._poly_points(st)
        if len(pts) >= 3:
            self._paint([(pts, True)], ctm, st, props, True)

    def _el_path(self, el, st, ctm, props) -> None:
        d = st.get("d", "")
        if not d:
            return
        subpaths = _parse_path(d, self.point_budget)
        if subpaths:
            self._paint(subpaths, ctm, st, props, False)

    def _el_text(self, el, st, ctm, props) -> None:
        """Best-effort text: PIL's scalable built-in font at the mapped
        size. Glyph shapes won't match a real renderer, but presence,
        position, color, and approximate extent count for similarity."""
        from PIL import ImageFont

        text = "".join(el.itertext()).strip()
        if not text:
            return
        x = _parse_length(st.get("x"), 0.0, self.vb[2])
        y = _parse_length(st.get("y"), 0.0, self.vb[3])
        size = _parse_length(st.get("font-size",
                                    props.get("font-size", "16")), 16.0)
        m = mat_mul(ctm, self.base)
        a, b, c, d, _, _ = m
        scale = math.sqrt(abs(a * d - b * c)) or 1.0
        px = max(4, min(512, int(round(size * scale))))
        try:
            font = ImageFont.load_default(px)
        except (TypeError, OSError):
            font = ImageFont.load_default()
        fill = _parse_color(st.get("fill", props.get("fill", "black"))) \
            or (0, 0, 0)
        dx, dy = mat_apply(m, x, y)
        anchor = st.get("text-anchor", props.get("text-anchor", "start"))
        try:
            tw = self.draw.textlength(text, font=font)
        except (TypeError, OSError):
            tw = px * 0.5 * len(text)
        if anchor == "middle":
            dx -= tw / 2.0
        elif anchor == "end":
            dx -= tw
        op = _parse_length(props.get("opacity", "1"), 1.0) * \
            _parse_length(props.get("fill-opacity", "1"), 1.0)
        alpha = max(0, min(255, int(round(op * 255))))
        # SVG y is the baseline; PIL draws from the ascender top.
        self.draw.text((dx, dy - px * 0.8), text, font=font,
                       fill=fill + (alpha,))


def extract_svg(text: str) -> Optional[str]:
    """Pull the first <svg>...</svg> block out of raw model output (models
    wrap SVG in markdown fences or prose; reference demo passes raw text to
    cairosvg which does the same scan)."""
    m = re.search(r"<svg\b.*?</svg\s*>", text, re.DOTALL | re.IGNORECASE)
    return m.group(0) if m else None


def render_svg(svg_text: str,
               size: Optional[Tuple[int, int]] = None) -> Image.Image:
    """Render SVG source to an RGB PIL image.

    Uses cairosvg when installed (the reference's renderer,
    ``requirements.txt:12``); otherwise the bounded built-in rasterizer.
    Raises :class:`SVGRenderError` on unusable input.
    """
    if not isinstance(svg_text, str) or not svg_text.strip():
        raise SVGRenderError("empty SVG")
    if len(svg_text) > MAX_SVG_BYTES:
        raise SVGRenderError("SVG too large")
    doc = extract_svg(svg_text) or svg_text
    if "<!DOCTYPE" in doc or "<!ENTITY" in doc:
        raise SVGRenderError("DTD/entities not allowed")
    try:
        import cairosvg  # optional; absent in this environment
        import io

        kwargs = {}
        if size is not None:
            kwargs = {"output_width": size[0], "output_height": size[1]}
        png = cairosvg.svg2png(bytestring=doc.encode("utf-8"), **kwargs)
        img = Image.open(io.BytesIO(png))
        bg = Image.new("RGB", img.size, (255, 255, 255))
        if img.mode in ("RGBA", "LA", "PA"):
            bg.paste(img, (0, 0), img.convert("RGBA"))
        else:
            bg.paste(img.convert("RGB"), (0, 0))
        return bg
    except ImportError:
        pass
    try:
        root = ET.fromstring(doc)
    except ET.ParseError as e:
        # Model output is often truncated mid-tag; try auto-closing.
        repaired = _autoclose(doc)
        if repaired is None:
            raise SVGRenderError(f"unparseable SVG: {e}") from e
        try:
            root = ET.fromstring(repaired)
        except ET.ParseError:
            raise SVGRenderError(f"unparseable SVG: {e}") from e
    if _local(root.tag) != "svg":
        raise SVGRenderError("root element is not <svg>")
    return _SVGRasterizer(root, out_size=size).run()


def _autoclose(doc: str) -> Optional[str]:
    """Salvage truncated model SVG: drop a trailing partial tag and append
    the missing close tags (same spirit as utils/repair.py for JSON)."""
    # Drop an unterminated trailing tag fragment.
    last_lt = doc.rfind("<")
    if last_lt > doc.rfind(">"):
        doc = doc[:last_lt]
    opens: List[str] = []
    for m in re.finditer(r"<(/?)([A-Za-z][\w:-]*)((?:[^>\"']|\"[^\"]*\"|'[^']*')*?)(/?)>", doc):
        closing, name, _body, selfclose = m.groups()
        if selfclose:
            continue
        if closing:
            if opens and opens[-1] == name:
                opens.pop()
        else:
            opens.append(name)
    if not opens and "<svg" in doc:
        return doc
    if not opens:
        return None
    return doc + "".join(f"</{name}>" for name in reversed(opens))


# --------------------------------------------------------------------------
# Scoring.
# --------------------------------------------------------------------------

def _ssim_gray(a, b) -> float:
    """Global-window SSIM on [0,1] grayscale arrays (the standard constants
    C1=(0.01L)^2, C2=(0.03L)^2) computed over 8x8 block statistics —
    deterministic, numpy-only."""
    import numpy as np

    def blocks(x):
        h, w = x.shape
        bh, bw = h // 8, w // 8
        if bh == 0 or bw == 0:
            return x.reshape(1, 1, -1)
        x = x[: bh * 8, : bw * 8]
        return x.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh, bw, 64)

    xa, xb = blocks(a), blocks(b)
    mu_a, mu_b = xa.mean(-1), xb.mean(-1)
    va, vb = xa.var(-1), xb.var(-1)
    cov = ((xa - mu_a[..., None]) * (xb - mu_b[..., None])).mean(-1)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)
    )
    return float(ssim.mean())


def score_svg(svg_text: str, target: Image.Image,
              compare_size: int = 256) -> Dict[str, float]:
    """Render ``svg_text`` and score it against ``target`` (the source
    image the model was asked to reproduce).

    Returns ``renderable`` (0/1), ``l1`` (mean abs color error, 0..1),
    ``ssim`` (structural similarity, -1..1), and ``score`` — the composite
    ``0.5 * (1 - l1) + 0.5 * max(0, ssim)`` in [0, 1]. An unrenderable SVG
    scores 0 across the board (matching how the official eval treats
    cairosvg failures: no image, no credit).
    """
    import numpy as np

    try:
        rendered = render_svg(svg_text)
    except SVGRenderError:
        return {"renderable": 0.0, "l1": 1.0, "ssim": 0.0, "score": 0.0}
    tw, th = target.size
    s = compare_size / max(tw, th, 1)
    size = (max(1, int(tw * s)), max(1, int(th * s)))
    a = np.asarray(rendered.convert("RGB").resize(size, Image.BILINEAR),
                   np.float32) / 255.0
    b = np.asarray(target.convert("RGB").resize(size, Image.BILINEAR),
                   np.float32) / 255.0
    l1 = float(np.abs(a - b).mean())
    ssim = _ssim_gray(a.mean(-1), b.mean(-1))
    score = 0.5 * (1.0 - l1) + 0.5 * max(0.0, ssim)
    return {"renderable": 1.0, "l1": l1, "ssim": ssim,
            "score": float(score)}


# ---------------------------------------------------------------------------
# Optional CLIP-space term (UniSVG composite parity)
# ---------------------------------------------------------------------------

_CLIP_CACHE: Dict[str, object] = {}


def _load_clip(model_name: str):
    """Load a CLIP vision tower via transformers (cached). Returns None
    when the model cannot be loaded (no network / weights absent) — the
    caller falls back to the pixel-space score."""
    if model_name in _CLIP_CACHE:
        return _CLIP_CACHE[model_name]
    try:
        import os

        from transformers import CLIPImageProcessor, CLIPVisionModel

        # local_files_only unless the caller opted into network: a cache
        # miss then fails in milliseconds instead of hanging on hub
        # retries (this build env has zero egress).
        local_only = os.environ.get("SVG_CLIP_ONLINE", "0") != "1"
        proc = CLIPImageProcessor.from_pretrained(
            model_name, local_files_only=local_only
        )
        model = CLIPVisionModel.from_pretrained(
            model_name, local_files_only=local_only
        )
        _CLIP_CACHE[model_name] = (proc, model)
    except Exception:  # noqa: BLE001 — offline / missing weights
        _CLIP_CACHE[model_name] = None
    return _CLIP_CACHE[model_name]


def clip_similarity(a: Image.Image, b: Image.Image,
                    model_name: str = "openai/clip-vit-base-patch32"):
    """Cosine similarity of pooled CLIP vision embeddings, or None when
    CLIP weights are unavailable (zero-egress build env). Run on weights
    day alongside the checkpoint download."""
    loaded = _load_clip(model_name)
    if loaded is None:
        return None
    import numpy as np
    import torch

    proc, model = loaded
    with torch.no_grad():
        feats = []
        for im in (a.convert("RGB"), b.convert("RGB")):
            inputs = proc(images=im, return_tensors="pt")
            out = model(**inputs).pooler_output[0].numpy()
            feats.append(out / (np.linalg.norm(out) + 1e-8))
    return float(np.dot(feats[0], feats[1]))


def score_svg_composite(svg_text: str, target: Image.Image,
                        compare_size: int = 256,
                        clip_model: str = "openai/clip-vit-base-patch32",
                        clip_weight: float = 0.4) -> Dict[str, float]:
    """UniSVG-style composite: the pixel-space score blended with a
    CLIP-space similarity term when CLIP weights are available
    (``composite = (1 - w) * pixel_score + w * clip_cos``), else the
    pixel score with ``clip`` reported as -1 (absent). This closes the
    STRUCTURAL gap with the published composite (VERDICT r4 missing #3);
    the numeric weights of the official UniSVG blend are not published —
    calibrate ``clip_weight`` against the official harness when
    reachable."""
    base = score_svg(svg_text, target, compare_size=compare_size)
    if not base["renderable"]:
        base["clip"] = -1.0
        base["composite"] = 0.0
        return base
    try:
        rendered = render_svg(svg_text)
    except SVGRenderError:  # pragma: no cover — renderable above
        base["clip"] = -1.0
        base["composite"] = base["score"]
        return base
    sim = clip_similarity(rendered, target, model_name=clip_model)
    if sim is None:
        base["clip"] = -1.0
        base["composite"] = base["score"]
    else:
        base["clip"] = sim
        base["composite"] = float(
            (1.0 - clip_weight) * base["score"]
            + clip_weight * max(0.0, sim)
        )
    return base
