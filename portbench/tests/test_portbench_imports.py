"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names, and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from portbench import manifest
from portbench.run import forbidden_modules

ROOT = str(manifest.ROOT)


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax",
                              "nbmf_mm_tpu", "nbmf_mm_tpu.ops"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla_client", "nbmf_mm_tpu", "nbmf_mm_tpu.ops"]
    assert forbidden_modules(["nbmf_mm_tpu_torch", "nbmf_mm_tpu_torch.ops", "jaxtyping",
                              "portbench", "numpy"]) == []


def _modules_after(code: str) -> list:
    """Top-level names of the modules loaded by ``code`` in a fresh
    interpreter without the test session's site settings."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    script = code + ("\nimport sys, json\n"
                     "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import portbench.reference, portbench.compare, portbench.data, "
                            "portbench.roofline, portbench.tracing")
    assert not {"nbmf_mm_tpu_torch", "nbmf_mm_tpu", "jax", "jaxlib"} & set(loaded)


def test_a_run_loads_no_jax():
    """The harness's whole run on the CPU at a tiny size, then the run's own
    look at ``sys.modules``."""
    code = (
        "from portbench.tests.cells import tiny_cell\n"
        "from portbench import harness\n"
        "from portbench.run import forbidden_modules\n"
        "import sys\n"
        "out = harness.run(tiny_cell('flagship_fit'), 3, 0.1, False, device='cpu')\n"
        "assert out['result']['correct'], out\n"
        "assert forbidden_modules(sys.modules) == [], forbidden_modules(sys.modules)\n"
    )
    loaded = _modules_after(code)
    assert "nbmf_mm_tpu_torch" in loaded
    assert not {"nbmf_mm_tpu", "jax", "jaxlib", "flax"} & set(loaded)


def test_no_card_no_result():
    """Without a card the command prints no result and fails."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "flagship_fit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
