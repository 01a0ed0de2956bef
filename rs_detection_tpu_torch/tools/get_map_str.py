"""Format a validation-log AP line into ordered per-class tables
(counterpart of ``tools/analysis_tools/get_map_str.py``): every
``<Name>_AP:<float>`` token and ``meanAP`` of the line, printed in the
submission's number order and in the dataset's class order
(``config/constant.py``).

Usage:
  python -m rs_detection_tpu_torch.tools.get_map_str "<log line>" \\
      [--dataset FAIR1M_1_5]
"""

import argparse
import re

from ..config.constant import get_classes_by_name

NUMBER_ORDER = ["Vehicle", "Airplane", "Ship", "Intersection",
                "Tennis_Court", "Basketball_Court", "Bridge",
                "Baseball_Field", "Football_Field", "Roundabout"]


def parse_ap_line(line: str):
    aps = {m.group(1): float(m.group(2))
           for m in re.finditer(r"(\w+)_AP:([0-9.]+)", line)}
    mean = re.search(r"meanAP:([0-9.]+)", line)
    return aps, float(mean.group(1)) if mean else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("line", help="log line containing X_AP:... tokens")
    ap.add_argument("--dataset", default="FAIR1M_1_5")
    args = ap.parse_args(argv)
    aps, mean = parse_ap_line(args.line)

    print("Number Order:\n")
    for name in NUMBER_ORDER:
        if name in aps:
            print(f"{aps[name]:.4f}  - {name}")
    print("\nCLASSES Order:\n")
    for name in get_classes_by_name(args.dataset):
        if name in aps:
            print(f"{aps[name]:.4f}  - {name}")
    if mean is not None:
        print(f"{mean:.4f}  - meanAP")


if __name__ == "__main__":
    main()
