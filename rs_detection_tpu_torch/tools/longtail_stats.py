"""Long-tail dataset statistics (counterpart of
``tools/analysis_tools/longtail_stats.py``): per-class instance counts,
frequencies and the imbalance of a ``labels.pkl``, classes named by
``config/constant.py``.

Usage:
  python -m rs_detection_tpu_torch.tools.longtail_stats \\
      --labels labels.pkl [--classes DOTA]
"""

import argparse
import pickle
from collections import Counter

from ..config.constant import get_classes_by_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--labels", required=True)
    ap.add_argument("--classes", default="DOTA")
    args = ap.parse_args(argv)

    classes = get_classes_by_name(args.classes)
    with open(args.labels, "rb") as f:
        infos = pickle.load(f)
    counts = Counter()
    for info in infos:
        for label in info.get("ann", {}).get("labels", []):
            counts[int(label)] += 1
    total = sum(counts.values())
    print(f"{'class':25s}{'count':>10s}{'freq':>10s}")
    for i, name in enumerate(classes):
        c = counts.get(i + 1, 0)
        print(f"{name:25s}{c:10d}{c / max(total, 1):10.4f}")
    vals = sorted(counts.values(), reverse=True)
    if len(vals) > 1:
        print(f"\nimages: {len(infos)}  instances: {total}  "
              f"imbalance (max/min): {vals[0] / max(vals[-1], 1):.1f}")


if __name__ == "__main__":
    main()
