"""Checkpoint / resume for long IK sweeps (SURVEY.md section 5).

The reference has no checkpointing; its closest mechanisms are warm-started
cvxpy problems and caller-supplied Y_init (reference sdp_snl.py:741-760,
riemannian_solver.py:199-200). For fleet-scale sweeps on accelerators the useful
equivalent is: persist the sweep cursor (seed counter), accumulated metrics,
and optionally the last solver-state pytree, so an interrupted sweep resumes
at the next batch instead of re-solving from goal zero.

Format: a single .npz with a flattened pytree (names are path-joined keys)
plus a JSON-encoded metadata blob. No framework dependencies beyond numpy;
arrays round-trip through host memory (checkpoints are between-batch events,
never inside jit).
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Tuple

import numpy as np

_META_KEY = "__graphik_tpu_meta__"
_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            # "/" is the nesting separator and the meta key is reserved;
            # allowing either in user keys would silently mis-nest on load.
            if _SEP in str(k) or str(k) == _META_KEY:
                raise ValueError(
                    f"checkpoint state key {k!r} is reserved: keys may not "
                    f"contain {_SEP!r} or equal {_META_KEY!r}"
                )
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def save_checkpoint(path: str, state: Dict[str, Any], meta: Dict[str, Any]
                    | None = None) -> None:
    """Atomically write `state` (a dict pytree of arrays) + `meta` (JSON).

    Writes to a temp file in the target directory then os.replace()s it so a
    crash mid-write never leaves a truncated checkpoint.
    """
    arrays = _flatten(state)
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            # Write the .npz container directly instead of np.savez(**arrays):
            # savez takes entries as kwargs, so a state key named "file"
            # (savez's positional parameter) would raise TypeError.
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
                for key, arr in arrays.items():
                    with zf.open(key + ".npy", "w") as af:
                        np.lib.format.write_array(
                            af, np.asarray(arr), allow_pickle=False
                        )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a checkpoint; returns (state, meta).

    State keys are re-nested on the path separator into dicts (list/tuple
    structure is restored as dicts keyed by stringified index, which jit
    consumers treat identically as pytrees).
    """
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode()) \
            if _META_KEY in z.files else {}
        state: Dict[str, Any] = {}
        for key in z.files:
            if key == _META_KEY:
                continue
            parts = key.split(_SEP)
            cur = state
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = z[key]
    return state, meta
