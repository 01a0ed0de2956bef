"""MD5 of checkpoint or submission files (counterpart of
``tools/md5.py``), e.g. to fingerprint an SWA checkpoint before a
submission.

Usage:
  python -m rs_detection_tpu_torch.tools.md5 work_dir/checkpoints/swa_8-9.pkl
"""

import hashlib
import os
import sys


def get_md5_of_file(file_path: str):
    """The lowercase hex MD5 of a file, or None where there is none."""
    if not os.path.isfile(file_path):
        return None
    md5 = hashlib.md5()
    with open(file_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            md5.update(chunk)
    return md5.hexdigest().lower()


def main(argv=None):
    for p in (sys.argv[1:] if argv is None else argv):
        print(f"{get_md5_of_file(p)}  {p}")


if __name__ == "__main__":
    main()
