"""The port stands alone: no module of kalle_tpu_torch, and not
chip_smoke.py, imports jax or the kalle_tpu package (AST scan)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "kalle_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "kalle_tpu")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_kalle_tpu_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in FILES}
    assert {"llama.py", "generate.py", "sigmavae.py", "chip_smoke.py", "flash_attention.py",
            "trainer.py", "datasets.py", "checkpoint.py", "serve_loop.py", "service.py",
            "http.py", "web.py", "audio.py", "pipeline.py", "cli.py", "batch_cli.py",
            "app.py", "oobleck.py", "melvae.py", "ecapa.py", "mrte.py", "variants.py",
            "cfg.py", "streaming.py", "online.py", "mel.py", "alias_free.py",
            "codec_trainer.py", "discriminators.py", "codec_losses.py", "flow_kl.py",
            "synth_speech.py", "ctc_asr.py", "speaker_embedder.py", "wer.py", "harness.py",
            "codec_demo.py"} <= names
