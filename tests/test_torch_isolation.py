"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
`repro`, and each framework-free module it copied from `repro` is the
original with only its `repro.` imports rewritten to `repro_torch.`."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

COPIED = [
    "core/__init__.py", "core/request.py", "core/events.py",
    "core/preemption.py", "core/predictor.py", "core/scheduler.py",
    "core/metrics.py", "core/dispatch.py", "core/prefixcache.py",
    "core/tieredcache.py", "core/faults.py",
    "configs/base.py", "configs/llama3_8b.py",
]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
"""


def test_importing_every_module_leaves_out_jax_and_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20, out          # every module of the package
    assert out[1].strip() == "[]", out[1]


def test_no_source_mentions_jax_or_repro_imports():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                         r"from repro\.|from repro import|import repro$)",
                         re.MULTILINE)
    sources = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu")]
    assert len(sources) >= 25
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_original(rel):
    original = (SRC / "repro" / rel).read_text()
    rewritten = re.sub(r"\brepro\.", "repro_torch.", original)
    assert (PORT / rel).read_text() == rewritten
