"""Command line of the port (counterpart of ``tools/run_net.py``):

    python -m rs_detection_tpu_torch.tools.run_net --config-file CFG \
        --task train|val|test|vis_test [--flip_test] [--save_dir DIR] [--cpu]

``--task train`` runs the config's training (``Runner.run``: epochs,
checkpoints under ``work_dir/checkpoints``, the SWA switch-over, val
when the config sets ``eval_interval`` and at the end), resuming from
the newest checkpoint of the work directory or ``resume_path``.
``--task val`` computes the val dataset's mAP. ``--task test`` serves
the config's test tiles and writes the results pickle, the merged
per-class files and the submission under the work directory
(``submit_zips/`` under the working directory); flip-TTA runs when
``--flip_test`` is passed or the config sets ``flip_test``. ``vis_test``
draws the detections on the images of the config's ``vis_test_dir``.
The model runs on the CUDA card (an error where there is none) unless
``--cpu`` is passed.

Data parallel: ``torchrun --nproc_per_node N -m
rs_detection_tpu_torch.tools.run_net ...`` runs one process a card,
joined by NCCL (with ``--cpu``: N host processes joined by gloo); the
config's batch size is the global batch, which N must divide. A plain
``python -m`` run is one process, as is ``torchrun --nproc_per_node 1``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Run one task; returns the Runner."""
    parser = argparse.ArgumentParser(
        description="rs_detection_tpu_torch runner")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--task", default="train",
                        choices=["train", "val", "test", "vis_test"])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host CPU")
    parser.add_argument("--save_dir", default=None)
    parser.add_argument("--flip_test", action="store_true")
    args = parser.parse_args(argv)

    from ..config import get_cfg, init_cfg, update_cfg
    from ..parallel import dist
    from ..runner import Runner
    from ..utils.general import list_images

    init_cfg(args.config_file)
    if args.save_dir:
        update_cfg({"work_dir": args.save_dir})

    device = "cpu" if args.cpu else None
    grouped = dist.env_world() > 1 and not dist.world() > 1
    if grouped:
        device = dist.init_process_group(device=device)
    try:
        runner = Runner(device=device)
        if args.task == "train":
            runner.run()
        elif args.task == "val":
            runner.val()
        elif args.task == "test":
            runner.test(flip_test=args.flip_test
                        or bool(get_cfg().flip_test))
        else:
            imgs = list_images(get_cfg().vis_test_dir or ".")
            runner.run_on_images(imgs, save_dir=os.path.join(
                runner.work_dir, "vis"))
    finally:
        if grouped:
            dist.destroy_process_group()
    return runner


if __name__ == "__main__":
    main()
