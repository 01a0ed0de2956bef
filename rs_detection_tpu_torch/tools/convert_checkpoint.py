"""Convert a reference-trained (torch / Jittor) checkpoint into the
pickle that the port's ``Runner.load`` and ``pretrained_weights`` read
(counterpart of ``tools/convert_checkpoint.py``, without jax).

The source is a torch file (``.pth`` / ``.pt``, read with torch on the
CPU) or a pickle (``jt.save``): a flat ``{dotted.name: array}`` state
dict, or one under ``--key`` / ``state_dict`` / ``model``. The output is
the JAX tool's ``{meta, model={params, batch_stats}}`` pickle of
flax-form trees (``utils/checkpoint_convert.py:torch_state_to_flax``:
OIHW -> HWIO, [out, in] -> [in, out], BN statistics apart), which
``utils/checkpoint.py:read_checkpoint`` loads by name.

With ``--config`` the names are a JDet model's: they are remapped to the
port's (``tools/parity_check.py:remap_reference_names``), the RoI head's
first shared FC is permuted from the reference's (C, P, P) input order
(``head_fc_spatial``), and every name and shape is audited against the
config's model before anything is written (a mismatch prints each
problem and exits 2).

Usage:
  python -m rs_detection_tpu_torch.tools.convert_checkpoint \\
      --src van_b3.pth --out van_b3.pkl [--key state_dict] [--config CFG]
"""

import argparse
import os
import pickle
import zipfile

import numpy as np


def read_state(src, key=None):
    """The flat state dict of a torch file or a pickle, as numpy arrays."""
    if zipfile.is_zipfile(src):
        import torch

        state = torch.load(src, map_location="cpu", weights_only=False)
    else:
        with open(src, "rb") as f:
            state = pickle.load(f)
    if key:
        state = state[key]
    elif isinstance(state, dict) and isinstance(state.get("state_dict"),
                                                dict):
        state = state["state_dict"]
    elif isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in state.items()}


def convert(src, out, key=None, config=None):
    """Write the converted checkpoint of ``src`` to ``out``; returns the
    number of values converted."""
    from ..utils.checkpoint_convert import torch_state_to_flax
    from . import parity_check as pc

    state = read_state(src, key)
    fc_spatial = None
    if config is not None:
        model, cfg = pc.build_model(config)
        fc_spatial = pc.head_fc_spatial(cfg.model)
        problems = pc.audit(pc.convert_reference(state, fc_spatial),
                            pc.module_state(model), "state_dict")
        if problems:
            print(f"checkpoint audit FAILED ({len(problems)} mismatches):")
            print("\n".join(problems[:200]))
            raise SystemExit(2)
        state = pc.remap_reference_names(state)
    params, batch_stats = torch_state_to_flax(state, fc_spatial=fc_spatial)
    data = dict(meta=dict(source=os.path.basename(src)),
                model=dict(params=params, batch_stats=batch_stats))
    with open(out, "wb") as f:
        pickle.dump(data, f)
    return sum(np.asarray(v).size for v in state.values())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help=".pth / .pt torch file or a pickle")
    ap.add_argument("--out", required=True, help="output .pkl")
    ap.add_argument("--key", default=None,
                    help="sub-dict key holding the state_dict "
                         "(e.g. 'state_dict' or 'model')")
    ap.add_argument("--config", default=None,
                    help="a config of the port: remap JDet names to its "
                         "model's and audit them")
    args = ap.parse_args(argv)
    n = convert(args.src, args.out, args.key, args.config)
    print(f"wrote {args.out} ({n / 1e6:.1f}M params)")


if __name__ == "__main__":
    main()
