"""The port stands alone: importing ``repro_torch`` (every submodule,
``repro_torch.sim``, ``repro_torch.distributed``, the dry run and its
roofline (``launch.dryrun``, ``launch.roofline``) and the attribution
source (``core.instrumentation``, ``record``) among them) and
``chip_smoke`` pulls in neither jax nor the reference package, and no
source file of the port, ``chip_smoke.py`` or ``chip_mutants.py`` or the
port's examples (``examples/*_torch.py``) imports either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "repro" or module.startswith("repro."))


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n"
        "for m in ('optim.adamw', 'data.pipeline', 'checkpoint.manager',\n"
        "          'train.loop', 'train.step', 'launch.train',\n"
        "          'kernels.flash_attention', 'sim', 'sim.engine',\n"
        "          'sim.workloads', 'sim.cluster', 'distributed',\n"
        "          'distributed.coordinator', 'launch.dryrun',\n"
        "          'launch.roofline', 'core.instrumentation',\n"
        "          'record'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 50       # every submodule loaded


def test_no_port_source_imports_jax_or_the_reference():
    offenders = []
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                           ROOT / "chip_mutants.py"]
             + sorted((ROOT / "examples").glob("*_torch.py")))
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names
                          if _forbidden(n)]
    assert not offenders, offenders
    assert len(files) > 20
