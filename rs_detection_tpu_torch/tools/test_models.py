"""Run the port's golden-loss regressions family by family (counterpart
of ``tools/test_models.py``): ``tests/test_torch_golden_loss.py -k
<family>`` in its own pytest process for each family of
``tools/golden_streams.py`` (or those named), on the CPU. The test holds
each family's four port steps to its fixture or to the JAX stream, so it
needs the JAX package beside the port; the port itself needs none.

Usage:
  python -m rs_detection_tpu_torch.tools.test_models [family ...]
"""

import os
import subprocess
import sys

from .golden_streams import FAMILIES

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    names = list(sys.argv[1:] if argv is None else argv) or list(FAMILIES)
    unknown = sorted(set(names) - set(FAMILIES))
    if unknown:
        raise SystemExit(f"unknown families {unknown}; known: {FAMILIES}")
    failures = []
    for name in names:
        print("==>", name, flush=True)
        rc = subprocess.call(
            [sys.executable, "-m", "pytest",
             os.path.join(REPO, "tests", "test_torch_golden_loss.py"),
             "-k", f"[{name}]", "-x", "-q"],
            cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"})
        if rc != 0:
            failures.append(name)
    if failures:
        print("FAILED:", failures)
        sys.exit(1)
    print("all golden-loss regressions of the port passed")


if __name__ == "__main__":
    main()
