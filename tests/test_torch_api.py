"""coregex_tpu_torch's module-level ``match`` and ``match_string`` against
the JAX package's on the CPU: the same seeded texts, below and above the
engine's ``batch_threshold`` (16 KiB, where the call goes to the device
path), as bytes and as str, for patterns that match early, late and
nowhere; and both default to the card."""

import inspect

import numpy as np
import pytest
import torch

import coregex_tpu as ref_ct
import coregex_tpu_torch as ct

torch.set_num_threads(1)

THRESHOLD = 16 << 10
# (pattern, where its one match goes: "early", "late" or None)
CASES = [(r"\d+\.\d+", "late"), (r"\berror\b", "early"), (r"zq\d{3}", None)]
WORDS = ["alpha", "beta", "gamma", "delta", "x", "yy", "log", "warn"]


def _text(seed: int, size: int, where) -> str:
    """Seeded words and spaces of about `size` characters with one match
    of the case near the start or the end, or none."""
    rng = np.random.default_rng(seed)
    words = []
    total = 0
    while total < size:
        w = WORDS[int(rng.integers(len(WORDS)))]
        words.append(w)
        total += len(w) + 1
    hit = {"late": "12.5", "early": "error"}.get(where)
    if hit:
        words.insert(3 if where == "early" else len(words) - 3, hit)
    return " ".join(words)


@pytest.mark.parametrize("kind", ["bytes", "str"])
@pytest.mark.parametrize("size", [THRESHOLD // 4, 2 * THRESHOLD])
@pytest.mark.parametrize("pattern,where", CASES)
def test_match_equals_reference(pattern, where, size, kind):
    text = _text(len(pattern) + size, size, where)
    assert (len(text) >= THRESHOLD) == (size > THRESHOLD)
    data = text if kind == "str" else text.encode()
    got_m = ct.match(pattern, data, device="cpu")
    got_s = ct.match_string(pattern, text, device="cpu")
    assert got_m == ref_ct.match(pattern, data)
    assert got_s == ref_ct.match_string(pattern, text)
    assert got_m is got_s is (where is not None)


def test_match_exports_and_default_device():
    assert {"match", "match_string"} <= set(ct.__all__)
    for fn in (ct.match, ct.match_string):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert ct.compile(r"a", device="cpu").batch_threshold == THRESHOLD
