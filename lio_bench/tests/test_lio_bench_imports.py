"""No module that the harness or the reference loads is JAX's or the JAX
package's (top-level names compared whole: limovelo_tpu_torch is the
program, limovelo_tpu is not), and the reference loads nothing of the
program.  Each check runs in a fresh interpreter."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "limovelo_tpu"}


def _loaded(code: str) -> set:
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax():
    top = _loaded(
        "import time\n"
        "from lio_bench.drive import run_cell\n"
        "from lio_bench.tests.tiny import tiny_cell\n"
        "r = run_cell(tiny_cell('kitti_hdl64.online'), 3, 2.0, True, time.perf_counter(),"
        " device='cpu')\n"
        "assert r['_info']['messages'] > 0\n")
    assert "limovelo_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import lio_bench.reference.replay, lio_bench.reference.lio.step\n"
                  "import lio_bench.traffic.stream, lio_bench.compare")
    assert not top & (FORBIDDEN | {"limovelo_tpu_torch"})


def test_run_refuses_without_a_card():
    r = subprocess.run([sys.executable, str(ROOT / "lio_bench" / "run.py"), "--workload",
                        "kitti_hdl64.online", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
