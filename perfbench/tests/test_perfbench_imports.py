"""What the harness loads, and where it refuses to run (CPU, in fresh processes)."""
import os
import re
import shutil
import subprocess
import sys

import pytest

import tinybench

REPO = tinybench.REPO
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _python(code: str, cwd=REPO, pythonpath=None):
    env = dict(os.environ, PYTHONPATH=pythonpath or str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_cells_imports_load_no_jax(kind):
    """Everything a cell of this kind imports, the port's modules it drives
    included; top-level names compared whole (``repro_torch`` is not ``repro``)."""
    code = f"""
import sys
sys.path[:0] = [{str(REPO / 'perfbench')!r}]
from harness import runner, {kind}, manifest, profile, weights, traffic, flops, peaks
from reference import decoder, hosgd, hashdir
import repro_torch.models.transformer, repro_torch.serving, repro_torch.core.distributed
import repro_torch.core.ho_sgd, repro_torch.launch.mesh, repro_torch.opt.optimizers
import repro_torch.kernels.ops
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print(runner.forbidden_modules())
"""
    res = _python(code)
    assert res.returncode == 0, res.stderr
    loaded = set(eval(res.stdout.splitlines()[-2]))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN
    assert res.stdout.splitlines()[-1] == "[]"


def test_the_guard_names_what_it_finds():
    res = _python(f"""
import sys, types
sys.path[:0] = [{str(REPO / 'perfbench')!r}]
from harness import runner
sys.modules['repro.core'] = types.ModuleType('repro.core')
print(runner.forbidden_modules())
""")
    assert res.stdout.strip() == "['repro']", res.stderr


def test_the_reference_imports_nothing_of_the_program():
    res = _python(f"""
import sys
sys.path[:0] = [{str(REPO / 'perfbench')!r}]
from reference import decoder, hosgd, hashdir
print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'repro_torch', 'repro', 'jax'}}))
""", pythonpath=os.pathsep)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        assert not re.search(r"^\s*(from|import)\s+repro", path.read_text(), re.M), path


def test_the_hash_is_the_ports():
    import torch

    from reference import hashdir
    from repro_torch.core import directions

    assert hashdir.fold(2**31 + 5, 3, 0, 7) == directions.fold(2**31 + 5, 3, 0, 7)
    salt = directions.fold(11, 2, 0, 4)
    want = directions.gaussian_from_salt((5000,), salt, offset=2**32 - 100)
    got = hashdir.gaussians(2**32 - 100, 5000, salt, "cpu")
    assert torch.equal(got, want)


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    cmd = ["python3", "perfbench/run.py", "--workload", "hymba-1.5b.ho-tau8", "--seed",
           str(2**31 + 3), "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
