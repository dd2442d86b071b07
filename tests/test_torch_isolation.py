"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
`repro`, and each framework-free module it copied from `repro` is the
original with only its `repro.` imports rewritten to `repro_torch.`. The
same holds for the port's examples (`examples/*_torch.py`) and for
`chip_smoke.py`, which run where JAX is not installed."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
# the scripts beside the package that run the port alone
SCRIPTS = sorted((ROOT / "examples").glob("*_torch.py")) + \
    [ROOT / "chip_smoke.py"]

COPIED = [
    "core/__init__.py", "core/request.py", "core/events.py",
    "core/preemption.py", "core/predictor.py", "core/scheduler.py",
    "core/metrics.py", "core/dispatch.py", "core/prefixcache.py",
    "core/tieredcache.py", "core/faults.py",
    "configs/base.py", "configs/llama3_8b.py", "configs/qwen3_30b_a3b.py",
    "configs/granite_moe_3b.py", "configs/mamba2_370m.py",
    "configs/recurrentgemma_9b.py", "configs/whisper_large_v3.py",
    "configs/internvl2_76b.py", "configs/llama4_maverick_400b.py",
    "configs/llama3_2_1b.py", "configs/qwen2_1_5b.py",
    "configs/qwen2_5_3b.py", "configs/minitron_4b.py",
    "distributed/collectives.py",
    "sim/costmodel.py", "sim/simulator.py", "sim/cluster.py",
    "sim/policies.py",
    "traces/qwentrace.py", "traces/scenarios.py",
]

# modules of the JAX package with no port file, each with its reason
NO_COUNTERPART = {
    # XLA's cost analysis counts a scanned body once; the port's layer
    # loops are eager and counted per trip (launch/dryrun.py's docstring)
    "models/scan_ctl.py",
}

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"script{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path)
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
"""


def test_importing_every_module_leaves_out_jax_and_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL,
                          *map(str, SCRIPTS)], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    # every module of the package, the five examples and chip_smoke.py
    assert int(out[0]) >= 26, out
    assert out[1].strip() == "[]", out[1]


def test_no_source_mentions_jax_or_repro_imports():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                         r"from repro\.|from repro import|import repro$)",
                         re.MULTILINE)
    sources = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu")]
    assert len(sources) >= 25
    assert len(SCRIPTS) == 6
    sources += SCRIPTS
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_original(rel):
    original = (SRC / "repro" / rel).read_text()
    rewritten = re.sub(r"\brepro\.", "repro_torch.", original)
    assert (PORT / rel).read_text() == rewritten


def test_every_module_of_the_jax_package_has_a_port_file():
    """The port does all the JAX package does: each module of src/repro/
    has a file at the same path under src/repro_torch/, or is named in
    NO_COUNTERPART with its reason."""
    modules = {str(p.relative_to(SRC / "repro"))
               for p in (SRC / "repro").rglob("*.py")}
    missing = sorted(m for m in modules - NO_COUNTERPART
                     if not (PORT / m).exists())
    assert missing == []
    assert all(not (PORT / m).exists() for m in NO_COUNTERPART)
