"""No run loads JAX or the JAX package, and the reference loads nothing
of the program. Top-level module names are compared whole: the port's
name, ``mt_renderer_tpu_torch``, begins with the JAX package's."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

_RUN = """
import json, sys, time
import torch
torch.set_num_threads(2)
from portbench import bench
from portbench.tests.small import small
bench.run_cell("world.served", 3, 0.2, False, t_start=time.perf_counter(),
               device="cpu", overrides=small("world"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = """
import json, sys
import portbench.reference, portbench.reference_bcn, portbench.check
import portbench.views
import portbench.scenes.demo, portbench.scenes.world, portbench.scenes.bcn
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level(_RUN)
    assert "mt_renderer_tpu_torch" in mods        # the program did run
    assert not mods & {"jax", "jaxlib", "flax", "mt_renderer_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(_REFERENCE)
    assert not mods & {"mt_renderer_tpu_torch", "mt_renderer_tpu", "jax",
                       "jaxlib", "flax"}
