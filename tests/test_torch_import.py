"""coregex_tpu_torch stands alone: it imports torch and never jax (the GPU
machine it runs on has no jax), and nothing of the JAX package coregex_tpu,
not even its host modules.  A subprocess blocks `import jax` and `import
coregex_tpu` with a meta-path finder that raises, imports the package,
runs CPU counts and find_alls (a nullable pattern among them), is_match
and find_index calls against Python's re, and checks that neither entered
sys.modules."""

import os
import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "coregex_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, Block())

import re
import numpy as np
import torch
torch.set_num_threads(1)
import coregex_tpu_torch as ct

text = b"ip 10.0.0.1 or 192.168.1.10 and v1.2.3\n" * 600
pattern = r"\d+\.\d+\.\d+\.\d+"
eng = ct.compile(pattern, device="cpu")
exp = [m.span() for m in re.finditer(pattern.encode(), text)]
assert eng.count(np.frombuffer(text, dtype=np.uint8)) == len(exp)
assert eng.find_all_index(text) == exp
assert eng.find_index(text) == exp[0]
assert eng.is_match(text) is True
assert ct.compile(r"\s\d\s", device="cpu").is_match(text) is False
assert eng.batch_engine().host_routes == 0
# nullable: Go drops the empty match that abuts the previous match
exp, prev = [], -1
for m in re.finditer(rb"\w*", text):
    if not (m.start() == m.end() == prev):
        exp.append(m.span())
    prev = m.end()
eng = ct.compile(r"\w*", device="cpu")
assert eng.find_all_index(text) == exp
assert eng.count(text) == len(exp)
assert eng.batch_engine().host_routes == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "coregex_tpu"))
assert not bad, bad
print("ok")
"""


def test_import_and_slice_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_no_source_file_imports_jax():
    """Every module of the port, and chip_smoke.py, is free of imports of
    jax and of coregex_tpu (checked on the text, so a lazy import inside a
    function counts)."""
    pkg = ROOT / "coregex_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "bench", "coregex_tpu"), \
                    (f, line)
