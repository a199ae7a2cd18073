"""The benchmark of ``kbner_tpu_torch`` on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints,
as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also close standard error. Without CUDA, or with fewer cards than the
cell asks for, it prints no result and exits 2; if JAX or the JAX package
is loaded once the window has closed, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the program's kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
sys.path.insert(0, str(HERE.parent))

FORBIDDEN = {"jax", "jaxlib", "flax", "kbner_tpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cell as cells

    bench = cells.manifest()
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    cells.log(card_line())
    cell = cells.make_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    result = cells.run(cell, bench)
    result.pop("_ctx")
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return "card: " + out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: nvidia-smi unavailable ({e})"


if __name__ == "__main__":
    sys.exit(main())
