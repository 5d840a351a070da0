"""The port's copy of ``ingest/`` and of the native routines against the
JAX package's, on the PDFs and native inputs of ``tests/test_ingest.py``.

The JAX package's ingest tests run once in this module with recorders on
``minipdf.open_pdf`` and on every ``native.*_native`` entry point: each
PDF they open (image, text, vector, clip, shading, pattern, Type0 /
Type1 / Type3 / CFF fonts, CCITT, JBIG2, LZW, encrypted RC4 / AES) is then
rendered page by page by both packages and must give the same pixels (or
the same exception), and each recorded native call is replayed on the
port's library and must return the same bytes.
"""

import hashlib
import inspect

import numpy as np
import pytest
from PIL import Image

import test_ingest
from dots_ocr_tpu import native as jnative
from dots_ocr_tpu.ingest import minipdf as jmini
from dots_ocr_tpu.ingest import pdf as jpdf
from dots_ocr_tpu_torch import native as tnative
from dots_ocr_tpu_torch.ingest import minipdf as tmini
from dots_ocr_tpu_torch.ingest import pdf as tpdf

NATIVE = ("png_unpredict_native", "runlength_decode_native", "lzw_decode_native",
          "rc4_native", "jbig2_generic_native", "jbig2_symbol_dict_native", "patchify_native")


def _cases(fn):
    """Keyword sets to call a test_ingest test with (its parametrize mark
    expanded), or [] when a skipif mark holds or it needs other fixtures."""
    marks = getattr(fn, "pytestmark", [])
    if any(m.name == "skipif" and m.args and m.args[0] for m in marks):
        return []
    cases = [{}]
    for m in marks:
        if m.name == "parametrize":
            names = [n.strip() for n in m.args[0].split(",")]
            cases = [dict(zip(names, v if len(names) > 1 else (v,))) for v in m.args[1]]
    params = set(inspect.signature(fn).parameters)
    if params - set(cases[0]) - {"tmp_path"}:
        return []
    return cases


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Run the JAX package's ingest tests with recorders on; returns (PDF
    bytes by hash, native calls [(name, args, kwargs)], tests run)."""
    pdfs, calls = {}, []
    orig_open = jmini.open_pdf
    orig_native = {name: getattr(jnative, name) for name in NATIVE}

    def read(source):
        if isinstance(source, (bytes, bytearray)):
            return bytes(source)
        if hasattr(source, "read"):
            return source.read()
        with open(source, "rb") as f:
            return f.read()

    def open_rec(source):
        data = read(source)
        pdfs.setdefault(hashlib.sha1(data).hexdigest(), data)
        return orig_open(data)

    def native_rec(name):
        def rec(*args, **kwargs):
            calls.append((name, args, kwargs))
            return orig_native[name](*args, **kwargs)
        return rec

    jmini.open_pdf = open_rec
    for name in NATIVE:
        setattr(jnative, name, native_rec(name))
    ran = 0
    try:
        for name, fn in sorted(vars(test_ingest).items()):
            if not (name.startswith("test_") and callable(fn)):
                continue
            for kw in _cases(fn):
                if "tmp_path" in inspect.signature(fn).parameters:
                    kw = dict(kw, tmp_path=tmp_path_factory.mktemp(name))
                fn(**kw)
                ran += 1
    finally:
        jmini.open_pdf = orig_open
        for name, f in orig_native.items():
            setattr(jnative, name, f)
    return pdfs, calls, ran


def _render_all(mini, data, dpi):
    try:
        doc = mini.open_pdf(data)
        return [np.asarray(mini.render_page(doc, i, dpi=dpi)) for i in range(doc.page_count)]
    except Exception as e:  # noqa: BLE001 -- both packages must fail alike
        return type(e).__name__


def test_recorder_saw_the_corpus(recorded):
    pdfs, calls, ran = recorded
    assert ran >= 45 and len(pdfs) >= 30
    assert {name for name, _, _ in calls} >= {"lzw_decode_native", "rc4_native",
                                              "jbig2_generic_native"}


@pytest.mark.parametrize("dpi", [72, 150])
def test_every_recorded_pdf_renders_to_the_same_pixels(recorded, dpi):
    pdfs, _, _ = recorded
    rendered = 0
    for digest, data in sorted(pdfs.items()):
        want, got = _render_all(jmini, data, dpi), _render_all(tmini, data, dpi)
        if isinstance(want, str):
            assert got == want, digest
            continue
        assert len(got) == len(want), digest
        for a, b in zip(got, want):
            assert a.shape == b.shape and (a == b).all(), digest
            rendered += 1
    assert rendered >= 30


def test_native_calls_return_the_same_bytes(recorded):
    _, calls, _ = recorded
    assert tnative.get_lib() is not None and jnative.get_lib() is not None
    for name, args, kwargs in calls:
        want = getattr(jnative, name)(*args, **kwargs)
        got = getattr(tnative, name)(*args, **kwargs)
        if name == "jbig2_symbol_dict_native":
            # (dims, bits, export): bits is a buffer of which the symbols'
            # h * w prefix is written
            used = int((want[0][:, 0] * want[0][:, 1]).sum())
            assert (got[0] == want[0]).all() and (got[2] == want[2]).all(), name
            assert (got[1][:used] == want[1][:used]).all(), name
        elif isinstance(want, np.ndarray):
            assert (got == want).all(), name
        else:
            assert got == want, name


def test_patchify_and_filters_on_fresh_inputs():
    """The native routines the ingest tests do not reach on their own
    inputs: patchify, and the filters on random data."""
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 255, (56, 84, 3), np.uint8)
    perm = np.arange(24, dtype=np.int32)
    perm[-2:] = -1
    assert (tnative.patchify_native(arr, perm, 14, 6)
            == jnative.patchify_native(arr, perm, 14, 6)).all()
    data = rng.randint(0, 255, 4000, np.uint8).tobytes()
    assert tnative.rc4_native(b"key", data) == jnative.rc4_native(b"key", data)
    assert tnative.runlength_decode_native(data) == jnative.runlength_decode_native(data)
    for pred in (2, 10, 11, 12, 13, 14):
        assert (tnative.png_unpredict_native(data, pred, 19, 3, 8)
                == jnative.png_unpredict_native(data, pred, 19, 3, 8)), pred


def test_load_images_and_upsample_match(tmp_path):
    data = test_ingest._image_pdf_bytes([(200, 10, 10), (10, 200, 10)], size=(100, 60))
    path = tmp_path / "doc.pdf"
    path.write_bytes(data)
    assert tpdf.get_backend().name == jpdf.get_backend().name == "builtin"
    for dpi in (72, 200):
        want = jpdf.load_images_from_pdf(str(path), dpi=dpi)
        got = tpdf.load_images_from_pdf(str(path), dpi=dpi)
        assert [np.asarray(g).tolist() == np.asarray(w).tolist() for g, w in zip(got, want)] == \
            [True] * len(want)
    img = Image.fromarray(np.random.RandomState(1).randint(0, 255, (40, 70, 3), np.uint8))
    img.info["dpi"] = (72, 72)
    assert (np.asarray(tpdf.upsample_image_to_dpi(img, 200))
            == np.asarray(jpdf.upsample_image_to_dpi(img, 200))).all()
