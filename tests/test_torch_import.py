"""coregex_tpu_torch stands alone: it imports torch and never jax (the GPU
machine it runs on has no jax), and nothing of the JAX package coregex_tpu,
not even its host modules.  A subprocess blocks `import jax` and `import
coregex_tpu` with a meta-path finder that raises, imports the package,
runs CPU counts and find_alls (a nullable pattern, an overlapping
literal set and a BITSET_NFA pattern among them), is_match and find_index
calls, captures (find_all_submatch_index, replace_all), row batches
(is_match_batch, find_index_batch) and the multi-device layer (one
ShardedGoCount.count and one make_sharded_ends on a virtual mesh of four
CPU devices) against Python's re, and checks that neither entered
sys.modules."""

import os
import pathlib
import subprocess
import sys

import pytest
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
# a literal set whose hits overlap in 10.0.0.1: leftmost-first on the device
lit = ct.compile(r"0\.0|\.0\.", device="cpu")
assert lit.find_all_index(text) == [
    m.span() for m in re.finditer(rb"0\.0|\.0\.", text)]
assert lit.batch_engine().host_routes == 0
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
# BITSET_NFA (its DFA overflows): the bitset-NFA scan finds the starts
pattern = r"[a-q][^u-z]{13}x"
eng = ct.compile(pattern, device="cpu")
assert eng.strategy == "bitset_nfa"
t2 = b"a0123456789abcx zz " * 1000
exp = [m.span() for m in re.finditer(pattern.encode(), t2)]
assert eng.find_all_index(t2) == exp and eng.count(t2) == len(exp) == 1000
assert eng.is_match(t2) is True and eng.find_index(t2) == exp[0]
assert eng.batch_engine().host_routes == 0
# captures (the OnePass walk) and row batches (the row scans)
t3 = b"a12-foo b345-xy c6-zz q99-abc k1-m\n" * 20
eng = ct.compile(r"(\d+)-(\w+)", device="cpu")
exp = [[m.span(0), m.span(1), m.span(2)]
       for m in re.finditer(rb"(\d+)-(\w+)", t3)]
spans = eng.find_all_index(t3)
assert len(spans) == len(exp) >= 64
assert None not in eng._batch_captures(np.frombuffer(t3, np.uint8), spans)
assert eng.find_all_submatch_index(t3) == exp
assert eng.replace_all(t3, b"[$2:$1]") == re.sub(rb"(\d+)-(\w+)",
                                                 rb"[\2:\1]", t3)
eng = ct.compile(r"\d+\.\d+", device="cpu")
assert eng._batch_rows_ok()
assert eng.find_index_batch([b"x 1.2", b"no", b"3.4"]) == [(2, 5), None,
                                                            (0, 3)]
assert eng.is_match_batch([b"x 1.2", b"no"]) == [True, False]
# the multi-device layer on a virtual mesh of 4 CPU devices
from coregex_tpu_torch.ops.dfa_scan import DFATables
from coregex_tpu_torch.parallel import shard
from coregex_tpu_torch.parallel.sharded_count import ShardedGoCount
mesh = shard.Mesh(["cpu"] * 4)
arr = np.frombuffer(text, dtype=np.uint8)
be = ct.compile(r"\d+\.\d+", device="cpu").batch_engine()
# flag j: a match ends at boundary j
exp = [m.end() for m in re.finditer(rb"\d+\.\d+", text)]
assert ShardedGoCount(be._count_scanner().cd, mesh).count(arr) == len(exp)
n = len(arr) // 4 * 4
pos, cnt = shard.make_sharded_ends(
    mesh, DFATables.from_dense(be._dense("fwd_all")), 4096)(arr[:n])
ends = pos[pos < n].tolist()
assert int(cnt.sum()) == len(ends) > 0 and set(exp) <= set(ends)
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


def _imported(line: str):
    """The modules an import line names: `import a.b, c` gives a.b and c,
    `from a import b, c` gives a, a.b and a.c.  A parenthesised or
    continued line (`from a import (`, `from a import \\`) still gives a."""
    words = line.translate(str.maketrans(",()\\", "    ")).split()
    names = [w for i, w in enumerate(words)
             if w != "as" and (i == 0 or words[i - 1] != "as")]
    if names[:1] == ["import"]:
        return names[1:]
    if names[:1] == ["from"] and len(names) >= 3 and names[2] == "import":
        return [names[1]] + [f"{names[1]}.{w}" for w in names[3:]]
    return []


@pytest.mark.parametrize("line,mods", [
    ("import jax", ["jax"]),
    ("import numpy as np, jax.numpy as jnp", ["numpy", "jax.numpy"]),
    ("from jax import (", ["jax"]),
    ("from coregex_tpu.ops import \\", ["coregex_tpu.ops"]),
    ("from tools import _compact_exp as ce",
     ["tools", "tools._compact_exp"]),
    ("from bench import run as r, cells", ["bench", "bench.run",
                                           "bench.cells"]),
    ("x = 1  # import jax", []),
])
def test_imported_parses_every_import_form(line, mods):
    assert _imported(line) == mods


def test_no_source_file_imports_jax():
    """Every module of the port, the torch tools (tools/*_torch.py) and
    chip_smoke.py are free of imports of jax, of coregex_tpu and of the
    JAX compaction rig (tools._compact_exp, tools.profile_compact); the
    package imports nothing of tools at all (checked on the text, so a
    lazy import inside a function counts)."""
    pkg = ROOT / "coregex_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)
    assert len(files) > 10
    assert {"onepass_scan.py", "rowscan.py"} <= {f.name for f in files}
    # chip_smoke.py's phases import lazily, inside each phase: the text
    # scan below reads them, the captures-and-rows phase among them
    assert "def phase_e2e_captures_rows(" in \
        (ROOT / "chip_smoke.py").read_text()
    outside = sorted((ROOT / "tools").glob("*_torch.py"))
    assert {f.name for f in outside} >= {"profile_torch.py",
                                          "profile_compact_torch.py"}
    outside.append(ROOT / "chip_smoke.py")
    banned = ("jax", "jaxlib", "bench", "coregex_tpu", "tools._compact_exp",
              "tools.profile_compact")
    for f in files + outside:
        in_pkg = f not in outside
        for line in f.read_text().splitlines():
            for mod in _imported(line.strip()):
                assert not any(mod == b or mod.startswith(b + ".")
                               for b in banned), (f, line)
                assert not (in_pkg and mod.split(".")[0] == "tools"), \
                    (f, line)
