"""The port stands alone: no module of dots_ocr_tpu_torch (nor chip_smoke.py
or kernel_ab.py) imports jax or anything of the JAX package dots_ocr_tpu, even transitively
or inside a function, and chip_smoke.py refuses to run without a GPU or
outside a checkout (non-zero exit, no result line)."""

import ast
import glob
import os
import pkgutil
import shutil
import subprocess
import sys

import dots_ocr_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_no_module_imports_jax():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(dots_ocr_tpu_torch.__path__, "dots_ocr_tpu_torch.")
    )
    assert "dots_ocr_tpu_torch.engine.scheduler" in modules
    assert "dots_ocr_tpu_torch.serve.server" in modules
    # the parser's path: its copies and the modules ported with it
    assert {"dots_ocr_tpu_torch.parser", "dots_ocr_tpu_torch.cli", "dots_ocr_tpu_torch.__main__",
            "dots_ocr_tpu_torch.client.inference", "dots_ocr_tpu_torch.ingest.minipdf",
            "dots_ocr_tpu_torch.ingest.jbig2", "dots_ocr_tpu_torch.utils.boxes",
            "dots_ocr_tpu_torch.utils.repair", "dots_ocr_tpu_torch.models.loader",
            "dots_ocr_tpu_torch.engine.engine", "dots_ocr_tpu_torch.engine.generate",
            "dots_ocr_tpu_torch.ops.sampling"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'dots_ocr_tpu'))\n"
        "assert not leaked, leaked\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imported_modules(path, package):
    """Every module an ``import`` or ``from ... import`` names in the file,
    at any depth (function-level imports included); relative imports are
    resolved against ``package``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")[:len(package.split(".")) - node.level + 1] if node.level else []
            names.append(".".join(base + ([node.module] if node.module else [])))
    return names


def test_no_source_line_imports_the_jax_package(tmp_path):
    files = sorted(glob.glob(os.path.join(REPO, "dots_ocr_tpu_torch", "**", "*.py"),
                             recursive=True)) + [os.path.join(REPO, name)
                                                 for name in ("chip_smoke.py", "kernel_ab.py")]
    assert len(files) > 30
    offending = []
    for path in files:
        package = os.path.dirname(os.path.relpath(path, REPO)).replace(os.sep, ".")
        offending += [(os.path.relpath(path, REPO), name)
                      for name in _imported_modules(path, package)
                      if name.split(".")[0] in ("jax", "dots_ocr_tpu")]
    assert not offending, offending
    # the scan sees function-level and relative imports
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    import dots_ocr_tpu.native\n"
                     "    from dots_ocr_tpu.utils import x\n    from ..ops import y\n")
    assert _imported_modules(str(probe), "dots_ocr_tpu_torch.models") == [
        "dots_ocr_tpu.native", "dots_ocr_tpu.utils", "dots_ocr_tpu_torch.ops"]


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    import torch

    if torch.cuda.is_available():  # the refusal under test needs a host without a GPU
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    else:
        proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
