"""What the benchmark loads: no JAX, no JAX package, after a CPU dry run of
every mix at a tiny size, compared by whole top-level names; the reference
loads nothing of the program; run.py refuses to run without a card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark.harness.manifest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "holo_diffusion_tpu")
REFERENCE = ROOT / "benchmark" / "reference"

DRY_RUN = """
import json, sys, tempfile, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark.harness.manifest import Manifest
from benchmark.harness.runner import run_cell
from benchmark.tests.tiny import make_tiny_root
man = Manifest(make_tiny_root(tempfile.mkdtemp(dir={tmp!r})))
correct = {{}}
for w in [w["name"] for w in man.data["workloads"]]:
    for trace in (False, True):
        correct[w, trace] = run_cell(man, w, 11, 0.3, trace, "cpu", time.perf_counter(), log=lambda s: None)["correct"]
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "correct": all(correct.values())}}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_dry_run_of_every_mix_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", DRY_RUN.format(root=str(ROOT), tmp=str(tmp_path))],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path, env=_env())
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "holo_diffusion_torch" in res["modules"]
    assert not set(res["modules"]) & set(FORBIDDEN), set(res["modules"]) & set(FORBIDDEN)


def test_whole_name_comparison():
    """holo_diffusion_torch begins with the JAX package's letters: only a
    whole-name comparison tells them apart."""
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        import run
    finally:
        sys.path.pop(0)
    sys.modules["holo_diffusion_torch_probe"] = sys.modules["json"]
    try:
        assert "holo_diffusion_torch_probe" not in run.forbidden_modules()
        sys.modules["holo_diffusion_tpu"] = sys.modules["json"]
        assert run.forbidden_modules() == ["holo_diffusion_tpu"]
    finally:
        sys.modules.pop("holo_diffusion_torch_probe", None)
        sys.modules.pop("holo_diffusion_tpu", None)


def _imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program(tmp_path):
    for path in REFERENCE.glob("*.py"):
        names = set(_imported_names(path))
        assert not names & {"holo_diffusion_torch", *FORBIDDEN}, (path.name, names)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import benchmark.reference.model, "
            "benchmark.reference.render; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=tmp_path,
                         env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"holo_diffusion_torch", *FORBIDDEN}


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", "hydrant.train",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=_env())
    assert out.returncode != 0
    assert out.stdout.strip() == ""
