"""A run loads neither JAX nor the JAX package: the top-level name of every
module in the process, compared whole (``kbner_tpu_torch`` is not
``kbner_tpu``)."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

PROBE = """
import sys
sys.path.insert(0, {repo!r})
import portbench.run
from portbench.tests import bench_tiny
from pathlib import Path
import portbench.harness.control, portbench.harness.manifest
out = bench_tiny.run("large.serve.exh", Path({cache!r}), trace=True)
out = bench_tiny.run("large.finetune.b16", Path({cache!r}), trace=True)
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(",".join(top))
"""


def test_nothing_loads_jax_or_the_jax_package(tmp_path):
    res = subprocess.run([sys.executable, "-c", PROBE.format(
        repo=str(REPO), cache=str(tmp_path))], capture_output=True,
        text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    top = set(res.stdout.strip().splitlines()[-1].split(","))
    assert "kbner_tpu_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "kbner_tpu"}
