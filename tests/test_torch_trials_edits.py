"""The text edits of the kernel timing tools against today's ``csrc/``, on
the CPU: each variant of ``tools/k5b_trials.py``,
``tools/k3_bf16_trials.py``, ``tools/k1b_bf16_trials.py``,
``tools/k2_bf16_trials.py`` and ``tools/attn_walk_bf16_trials.py`` applies edits
that must match a stated number of times, and the tools stop before
building where one does not.  These tests
apply every variant's edits to the port's sources, as the tools do before
their builds, without building anything."""

import importlib.util
import re
from pathlib import Path

import pytest

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"trials_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_TOOLS = {name: _tool(name) for name in ("k5b_trials", "k3_bf16_trials", "k1b_bf16_trials",
                                         "k2_bf16_trials", "attn_walk_bf16_trials")}


@pytest.mark.parametrize("tool,variant", [(t, v) for t, mod in _TOOLS.items()
                                          for v in mod.VARIANTS])
def test_trial_edits_match_their_stated_counts(tool, variant):
    texts = _TOOLS[tool].edited(variant)
    assert set(texts) == {edit[0] for edit in _TOOLS[tool].VARIANTS[variant]}


def test_k5b_corrections_stay_in_k5bs_own_code():
    """``one_mma`` drops the two 3xTF32 correction MMAs of K5b's phases
    (fb_mma3 and fb_product: six lines) and leaves value_product's, which
    K5f, K5dq and K5dkv share, as they are."""
    mod = _TOOLS["k5b_trials"]
    pattern = mod._CORRECTIONS[1]
    before = (mod._build._CSRC / mod.FLASH).read_text()
    after = mod.edited("one_mma")[mod.FLASH]
    end = before.index(mod._K5B_END)
    assert len(re.findall(pattern, before[:end], flags=re.M)) == 6
    assert len(re.findall(pattern, after[:after.index(mod._K5B_END)], flags=re.M)) == 0
    assert after[after.index(mod._K5B_END):] == before[end:]
    assert len(re.findall(pattern, before[end:], flags=re.M)) == 2
