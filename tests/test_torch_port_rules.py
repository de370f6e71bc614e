"""Rules of the port that its code must keep.

- No module of src/repro_torch/, and not chip_smoke.py, imports ``jax`` or
  anything of the JAX package ``repro``: the port keeps its own copies.
- Entry points run on the card unless the caller asks for the CPU: with no
  card they raise, and never carry on silently on the CPU.
"""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    assert len(PORT_FILES) > 10 and all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    bad = [f"{path.relative_to(ROOT)}:{line}: {mod}"
           for line, mod in imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_scan_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\n"
                     "from repro.models import config\n"
                     "import repro_torch.models\n"
                     "import importlib\nimportlib.import_module('repro.rms')\n")
    mods = [m for _, m in imported_modules(probe)
            if m.split(".")[0] in FORBIDDEN]
    assert mods == ["jax.numpy", "repro.models", "repro.rms"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_card_unless_asked_for_cpu(no_card):
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, get_model, reduced_config
    from repro_torch.launch import serve

    cfg = reduced_config(get_config("smollm-135m"))
    for call in (lambda: build_model(cfg),
                 lambda: get_model("smollm-135m"),
                 lambda: get_model("mamba2-130m"),
                 lambda: params_from_jax({"w": [1.0]}),
                 lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_serve_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    for arch in ([], ["--arch", "mamba2-130m"]):
        assert serve.main(["--device", "cpu", "--requests", "2",
                           "--new-tokens", "2", "--batch", "2", *arch]) == 0
    out = capsys.readouterr().out
    assert "smollm-135m on cpu: 4 tokens, 2 requests" in out
    assert "mamba2-130m on cpu: 4 tokens, 2 requests" in out


def test_serve_launcher_runs_recurrentgemma_on_cpu(no_card, capsys):
    """The reduced recurrentgemma (rglru + local blocks) serves through the
    launcher on the CPU, and a card-less host refuses to build it on the
    default device."""
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("recurrentgemma-9b")
    assert serve.main(["--device", "cpu", "--arch", "recurrentgemma-9b",
                       "--requests", "3", "--new-tokens", "2",
                       "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "recurrentgemma-9b on cpu: 6 tokens, 3 requests" in out
    assert "recurrentgemma-9b: 6 layers, init" in out
