"""Cross-framework diff/debug tooling (counterpart of
``rs_detection_tpu/utils/check_diff.py``): record named activation,
weight or gradient tensors to pickles from either framework, then
compare two recordings tensor by tensor -- the tool that chases a parity
bug layer by layer.

    # the port's side
    rec = ActivationRecorder()
    rec.hook_torch(model)                 # forward hooks on every leaf
    model.predict(x)
    rec.save("acts_torch.pkl")

    # the other side: any nested tree of arrays (flax's
    # ``capture_intermediates`` output, a torch reference's dict)
    rec = ActivationRecorder()
    rec.record_tree("out", tree)
    rec.save("acts_ref.pkl")

    print(format_report(compare_data("acts_torch.pkl", "acts_ref.pkl")))

``compare_data(auto_layout=True)`` aligns two same-named 4-D tensors
that differ only by an NCHW <-> NHWC transpose before comparing them.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np

from .checkpoint_convert import compare_trees  # noqa: F401  (re-export)


def _to_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


class ActivationRecorder:
    """Collects a flat {name: ndarray} dict from either framework."""

    def __init__(self):
        self.data: Dict[str, np.ndarray] = {}
        self._handles = []

    # -- generic -------------------------------------------------------
    def add(self, name: str, value) -> None:
        self.data[name] = _to_numpy(value)

    def record_tree(self, prefix: str, tree: Any) -> None:
        """Flatten a (possibly nested) pytree of arrays into the
        recording; flax ``capture_intermediates`` output goes through
        here."""
        if isinstance(tree, dict):
            for k, v in tree.items():
                self.record_tree(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                self.record_tree(f"{prefix}.{i}", v)
        elif tree is not None:
            self.add(prefix, tree)

    # -- torch ---------------------------------------------------------
    def hook_torch(self, module, prefix: str = "") -> None:
        """Register forward hooks on every leaf submodule of a torch
        module; activations are recorded under their dotted paths."""
        for name, sub in module.named_modules():
            if len(list(sub.children())) > 0:
                continue
            full = f"{prefix}.{name}" if prefix and name else \
                (name or prefix or "root")

            def make_hook(key):
                def hook(_m, _inp, out):
                    if hasattr(out, "detach"):
                        self.data[key] = _to_numpy(out)
                return hook

            self._handles.append(sub.register_forward_hook(make_hook(full)))

    def unhook(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    # -- io ------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.data, f)

    @staticmethod
    def load(path: str) -> Dict[str, np.ndarray]:
        with open(path, "rb") as f:
            return pickle.load(f)


def _maybe_align_layout(a: np.ndarray, b: np.ndarray):
    """If a and b are 4-D and differ by a NCHW<->NHWC transpose, bring b
    to a's layout."""
    if a.ndim == 4 and b.ndim == 4 and a.shape != b.shape:
        if a.shape == tuple(np.asarray(b.shape)[[0, 2, 3, 1]]):
            return a, b.transpose(0, 2, 3, 1)
        if a.shape == tuple(np.asarray(b.shape)[[0, 3, 1, 2]]):
            return a, b.transpose(0, 3, 1, 2)
    return a, b


def compare_recordings(data_a: Dict[str, np.ndarray],
                       data_b: Dict[str, np.ndarray],
                       rtol: float = 1e-4, atol: float = 1e-5,
                       auto_layout: bool = True) -> Dict[str, dict]:
    """Per-name numeric report: max abs / max rel diff, shapes, and an
    ``ok`` verdict; names present on one side only are flagged."""
    report: Dict[str, dict] = {}
    for name in sorted(set(data_a) | set(data_b)):
        if name not in data_a:
            report[name] = dict(ok=False, error="missing in A")
            continue
        if name not in data_b:
            report[name] = dict(ok=False, error="missing in B")
            continue
        a, b = np.asarray(data_a[name]), np.asarray(data_b[name])
        if auto_layout:
            a, b = _maybe_align_layout(a, b)
        if a.shape != b.shape:
            report[name] = dict(ok=False,
                                error=f"shape {a.shape} vs {b.shape}")
            continue
        a64 = a.astype(np.float64)
        b64 = b.astype(np.float64)
        abs_diff = np.abs(a64 - b64)
        denom = np.maximum(np.abs(a64), np.abs(b64))
        rel = abs_diff / np.maximum(denom, 1e-12)
        max_abs = float(abs_diff.max()) if abs_diff.size else 0.0
        # rel diff only meaningful where the magnitude is non-tiny
        big = denom > atol
        max_rel = float(rel[big].max()) if big.any() else 0.0
        report[name] = dict(ok=bool(max_abs <= atol or max_rel <= rtol),
                            max_abs=max_abs, max_rel=max_rel,
                            shape=tuple(a.shape))
    return report


def compare_data(path_a: str, path_b: str, **kw) -> Dict[str, dict]:
    """Compare two saved recordings (reference ``compare_data``)."""
    return compare_recordings(ActivationRecorder.load(path_a),
                              ActivationRecorder.load(path_b), **kw)


def format_report(report: Dict[str, dict],
                  only_failures: bool = False) -> str:
    lines = []
    for name, r in report.items():
        if only_failures and r.get("ok"):
            continue
        if "error" in r:
            lines.append(f"{'FAIL':4} {name}: {r['error']}")
        else:
            lines.append(f"{'ok' if r['ok'] else 'FAIL':4} {name}: "
                         f"max_abs={r['max_abs']:.3e} "
                         f"max_rel={r['max_rel']:.3e} {r['shape']}")
    return "\n".join(lines) or "(empty report)"


def check_diff(path_a: str, path_b: str,
               rtol: float = 1e-4, atol: float = 1e-5,
               only_failures: bool = True) -> bool:
    """Print a comparison of two recordings; returns True if all names
    match (reference ``check_diff``)."""
    report = compare_data(path_a, path_b, rtol=rtol, atol=atol)
    print(format_report(report, only_failures=only_failures))
    return all(r.get("ok") for r in report.values())
