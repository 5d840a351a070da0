"""The port's copy of ``eval/`` (``metrics``, ``end2end``, ``elo``,
``omnidocbench``, ``svg``) against the JAX package's, on the CPU.

``tests/test_eval.py``, ``test_end2end.py``, ``test_metrics_layout.py``
and ``test_svg_eval.py`` are replayed on the port's modules
(``test_torch_tools.replay``), and every public function of the copied
modules is routed through ``test_torch_tools.twin_calls``: each call a
replayed test makes also runs the JAX module's function on a copy of its
arguments and must give the same result (the same pixels for a rendered
SVG) or raise the same exception. The SVG scorer's CLIP term keeps its
offline fallback (no CLIP weights are in the repository).
"""

import sys

import numpy as np
import pytest
from PIL import Image

from dots_ocr_tpu.eval import elo as jax_elo
from dots_ocr_tpu.eval import end2end as jax_end2end
from dots_ocr_tpu.eval import metrics as jax_metrics
from dots_ocr_tpu.eval import omnidocbench as jax_omnidocbench
from dots_ocr_tpu.eval import svg as jax_svg
from dots_ocr_tpu_torch.eval import elo, end2end, metrics, omnidocbench, svg
from test_torch_tools import plain, replay, twin_calls

REPLAYED = ("test_eval", "test_end2end", "test_metrics_layout", "test_svg_eval")
for _name in REPLAYED:
    globals().update(replay(_name))


@pytest.fixture(scope="module", autouse=True)
def _twins():
    mp = pytest.MonkeyPatch()
    twin_calls(mp, [(metrics, jax_metrics), (end2end, jax_end2end), (elo, jax_elo),
                    (omnidocbench, jax_omnidocbench), (svg, jax_svg)],
               replays=[sys.modules[f"torch_replay_{n}"] for n in REPLAYED],
               skip=("main", "run_sweep"))
    yield
    mp.undo()


def test_twins_are_active():
    assert metrics.normalized_edit_distance.twinned is not None
    assert svg.render_svg.twinned is not None
    assert sys.modules["torch_replay_test_end2end"].quick_match is end2end.quick_match


SVGS = [
    '<svg xmlns="http://www.w3.org/2000/svg" width="64" height="48" viewBox="0 0 64 48">'
    '<rect x="4" y="4" width="30" height="20" fill="#c03" stroke="navy" stroke-width="2"/>'
    '<circle cx="44" cy="30" r="12" fill="rgb(20,160,90)" opacity="0.7"/>'
    '<path d="M2 46 L30 30 Q50 10 62 44 Z" fill="none" stroke="black"/></svg>',
    '<svg width="40" height="40"><g transform="rotate(30 20 20) scale(0.8)">'
    '<polygon points="5,5 35,8 20,35" fill="orange"/><ellipse cx="20" cy="20" rx="10" ry="4"/>'
    '</g></svg>',
    "not an svg at all",
    '<svg width="30" height="30"><rect x="0" y="0" width="30" height="30" fill="blue"/>',
]


@pytest.mark.parametrize("index", range(len(SVGS)))
def test_svg_scores_match_jax(index):
    target = Image.fromarray(np.random.RandomState(index).randint(0, 255, (48, 64, 3), np.uint8))
    text = SVGS[index]
    assert plain(svg.extract_svg(text)) == plain(jax_svg.extract_svg(text))
    assert plain(svg.score_svg(text, target)) == plain(jax_svg.score_svg(text, target))
    assert plain(svg.score_svg_composite(text, target)) == plain(
        jax_svg.score_svg_composite(text, target))


TABLES = [
    ("<table><tr><td>a</td><td>b</td></tr><tr><td colspan='2'>c</td></tr></table>",
     "<table><tr><td>a</td><td>b</td></tr><tr><td>c</td><td></td></tr></table>"),
    ("<table><tr><th>x</th></tr></table>", "<table><tr><td>y</td></tr></table>"),
    ("", "<table><tr><td>1</td></tr></table>"),
]


@pytest.mark.parametrize("pred,gt", TABLES)
def test_table_and_text_metrics_match_jax(pred, gt):
    for structure_only in (False, True):
        assert metrics.teds(pred, gt, structure_only) == jax_metrics.teds(pred, gt, structure_only)
    assert metrics.normalized_edit_distance(pred, gt) == jax_metrics.normalized_edit_distance(
        pred, gt)
    assert metrics.normalize_markdown(pred + "\n\n**x**") == jax_metrics.normalize_markdown(
        pred + "\n\n**x**")
