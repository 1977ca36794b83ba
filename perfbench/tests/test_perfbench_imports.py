"""No run loads JAX or the JAX package (whole top-level names:
heston_tpu_torch begins with heston_tpu), and the reference loads
nothing of the program either."""

import json
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "heston_tpu"}


def top_level_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from perfbench import run, control, trace, endtoend, readers\n"
            "import heston_tpu_torch\n"
            "from heston_tpu_torch.models import calibration\n"
            "for k in ('quote', 'fit'):\n"
            "    run.load_kind(k)\n"
            "run.snapshot(run.load_counters())\n"
            "import os\n"
            "for f in os.listdir('perfbench/metrics'):\n"
            "    run.load_reader(f[:-3])\n")
    mods = top_level_modules(code)
    assert "heston_tpu_torch" in mods and "perfbench" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = top_level_modules(
        "import sys; sys.path.insert(0, '.')\n"
        "from perfbench.reference import heston_ref, lm, market\n"
        "from perfbench import roofline, traffic, endtoend")
    assert not mods & (FORBIDDEN | {"heston_tpu_torch"})


def test_forbidden_check_compares_whole_names(monkeypatch):
    from perfbench import run

    fake = type(sys)("fake")
    monkeypatch.setitem(sys.modules, "heston_tpu_torch_extra", fake)
    monkeypatch.setitem(sys.modules, "jaxtyping", fake)
    assert not set(run.forbidden_modules()) & {"heston_tpu_torch_extra",
                                               "jaxtyping"}
    monkeypatch.setitem(sys.modules, "heston_tpu.models", fake)
    assert "heston_tpu" in run.forbidden_modules()
    assert set(run.FORBIDDEN) == FORBIDDEN
