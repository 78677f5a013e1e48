"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor the JAX package, no source file imports them, and entry
points refuse to run without a GPU unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import FedAttnEngine

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(MODULES) >= 20


def test_no_source_file_imports_jax_or_repro():
    offenders = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(SRC)}: {n}")
    assert offenders == []


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("qwen2.5-7b")
    params = TransformerLM(cfg).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedAttnEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedAttnEngine(cfg, params, device="cuda")
    assert FedAttnEngine(cfg, params, device="cpu").backend == "torch"
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--n-new", "2"])
