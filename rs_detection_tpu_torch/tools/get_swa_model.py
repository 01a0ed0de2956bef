"""Average the weights of a run's checkpoints (counterpart of
``tools/get_swa_model.py``): the ``model`` of ``ckpt_<start>`` ...
``ckpt_<end>`` under ``work_dir/checkpoints``, each a checkpoint of the
port or of the JAX runner, into ``swa_<start>-<end>.pkl`` beside them,
in the port's format without optimizer state. A config serves or
evaluates it through ``resume_path`` or ``pretrained_weights``.

    python -m rs_detection_tpu_torch.tools.get_swa_model \\
        --work_dir WORK --start 8 --end 9
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..utils.checkpoint import FORMAT, read_checkpoint


def average_checkpoints(paths):
    """{"meta", "model"}: the last checkpoint's meta (in the port's
    format) and the element-wise mean of every checkpoint's model
    arrays, by name. Where a checkpoint of the port holds an EMA, its
    averages stand in for its parameters: the JAX runner's checkpoint of
    an EMA run holds the EMA as its model, and that is what its tool
    averages."""
    models, meta = [], {}
    for p in paths:
        m, arrays, _, ema = read_checkpoint(p)
        if ema is not None and m.get("format") == FORMAT:
            arrays = dict(arrays, **ema)
        models.append(arrays)
        meta = m or meta
    names = set(models[0])
    for p, arrays in zip(paths, models):
        if set(arrays) != names:
            raise ValueError(f"{p} holds other weights than {paths[0]}")
    avg = {k: np.mean(np.stack([np.asarray(a[k]) for a in models]), 0)
           for k in sorted(names)}
    return dict(meta=dict(meta, format=FORMAT), model=avg)


def get_swa_model(work_dir, start, end):
    """Write ``swa_<start>-<end>.pkl`` from the checkpoints of epochs
    ``start`` to ``end`` that exist; returns its path."""
    ckpts = os.path.join(work_dir, "checkpoints")
    paths = [os.path.join(ckpts, f"ckpt_{e}.pkl")
             for e in range(start, end + 1)]
    paths = [p for p in paths if os.path.exists(p)]
    if not paths:
        raise FileNotFoundError(f"no ckpt_{start}.pkl ... ckpt_{end}.pkl "
                                f"in {ckpts}")
    out = os.path.join(ckpts, f"swa_{start}-{end}.pkl")
    with open(out, "wb") as f:
        pickle.dump(average_checkpoints(paths), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="average checkpoints (SWA)")
    ap.add_argument("--work_dir", required=True)
    ap.add_argument("--start", type=int, required=True)
    ap.add_argument("--end", type=int, required=True)
    args = ap.parse_args(argv)
    out = get_swa_model(args.work_dir, args.start, args.end)
    print("saved", out)
    return out


if __name__ == "__main__":
    main()
