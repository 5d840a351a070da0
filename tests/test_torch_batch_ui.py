"""The port's copies of ``batch/`` (job manager, script engine) and
``ui/callbacks.py`` against the JAX package's, on the CPU.

``tests/test_batch.py`` and ``tests/test_ui_callbacks.py`` are replayed on
the port's modules (``test_torch_tools.replay``: the same fake parsers,
the port's job manager, script engine and callbacks). The pure functions
(the failure taxonomy, the user-script engine, the annotation and layout
callbacks) are also routed through ``test_torch_tools.twin_calls``, so
each of their calls must give the JAX module's result; the job manager's
threads and the parse callbacks, which write files, are held by the
replayed assertions and by the artifact comparison below.
"""

import sys
import time
import zipfile

import pytest

from dots_ocr_tpu.batch import jobs as jax_jobs
from dots_ocr_tpu.batch import script_engine as jax_script_engine
from dots_ocr_tpu.ui import callbacks as jax_callbacks
from dots_ocr_tpu_torch.batch import jobs, script_engine
from dots_ocr_tpu_torch.ui import callbacks
from test_torch_tools import replay, twin_calls

REPLAYED = ("test_batch", "test_ui_callbacks")
for _name in REPLAYED:
    globals().update(replay(_name))

PURE = ("is_transient_backend_error", "classify_parse_failure", "ui_update",
        "server_for_prompt", "annotation_to_bbox", "validate_annotation",
        "process_layout_response", "resolve_image_input", "show_page")


@pytest.fixture(scope="module", autouse=True)
def _twins():
    mp = pytest.MonkeyPatch()
    modules = [(jobs, jax_jobs), (script_engine, jax_script_engine), (callbacks, jax_callbacks)]
    skip = {name for port_mod, _ in modules for name in vars(port_mod) if name not in PURE}
    twin_calls(mp, modules, replays=[sys.modules[f"torch_replay_{n}"] for n in REPLAYED],
               skip=skip)
    yield
    mp.undo()


def test_twins_are_active():
    assert jobs.classify_parse_failure.twinned is not None
    assert callbacks.validate_annotation.twinned is not None


SCRIPT = """
ids = api.get_ids()
print("count", len(ids))
export.add_text("combined.md", "\\n".join(api.get_markdown(rid) for rid in ids))
"""


def _zip_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("fail", ["none", "transient", "permanent"])
def test_jobs_and_script_match_jax(tmp_path, image_file, fail):
    """The same document through both packages' job manager (with a
    transient failure retried, or a permanent one classified), then the
    same user script over each manager's results."""
    seen = []
    for name, jobs_mod, script_mod in (("port", jobs, script_engine),
                                       ("jax", jax_jobs, jax_script_engine)):
        replayed = sys.modules["torch_replay_test_batch"]
        parser = replayed.FakeParser(fail_times=2 if fail == "transient" else 0,
                                     permanent=fail == "permanent",
                                     fail_message="connection refused" if fail == "transient"
                                     else "cannot identify image file")
        mgr = jobs_mod.BatchJobManager(lambda: parser, output_dir=str(tmp_path / name),
                                       max_concurrency=1)
        mgr.start()
        rid = mgr.submit(image_file)
        deadline = time.time() + 30
        while time.time() < deadline and mgr.result(rid).status not in ("done", "error"):
            time.sleep(0.05)
        mgr.stop(wait=True)
        r = mgr.result(rid)
        zip_path, logs = script_mod.run_user_script(SCRIPT, mgr)
        seen.append((r.status, r.retry_attempts, r.error, logs,
                     zip_path and _zip_members(zip_path), mgr.progress()))
    assert seen[0] == seen[1]
    assert seen[0][0] == ("error" if fail == "permanent" else "done")
