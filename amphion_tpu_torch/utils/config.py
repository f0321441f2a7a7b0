"""Config loader: JSON with ``//`` comments and ``base_config`` inheritance.

The port's own copy of the part of `amphion_tpu/utils/config.py` that the
Vevo path needs, without the `json5` dependency: comments and trailing
commas are stripped, then the text is parsed as plain JSON. A config may
name a parent with ``base_config``; children override parents with a
deep merge. Relative parent paths are tried next to the child file, under
``$WORK_DIR`` and under the repository root.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

_TRAILING_COMMA = re.compile(r",(\s*[}\]])")


def _strip_comments(text: str) -> str:
    """Remove ``//`` line comments that lie outside string literals."""
    out, i, n, in_str = [], 0, len(text), False
    while i < n:
        ch = text[i]
        if in_str:
            out.append(ch)
            if ch == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 1
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
            out.append(ch)
        elif text.startswith("//", i):
            while i < n and text[i] != "\n":
                i += 1
            continue
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def loads(text: str) -> dict:
    """Parse JSON that may hold ``//`` comments and trailing commas."""
    return json.loads(_TRAILING_COMMA.sub(r"\1", _strip_comments(text)))


def override_config(base: dict, new: dict) -> dict:
    """Deep-merge ``new`` into a copy of ``base`` (dicts merge, leaves replace)."""
    out = dict(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = override_config(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_base_path(base_ref: str, child_path: Path) -> Path:
    candidates = [child_path.parent / base_ref]
    work_dir = os.environ.get("WORK_DIR")
    if work_dir:
        candidates.append(Path(work_dir) / base_ref)
    candidates.append(Path(__file__).resolve().parents[2] / base_ref)
    candidates.append(Path(base_ref))
    for c in candidates:
        if c.is_file():
            return c
    raise FileNotFoundError(
        f"base_config {base_ref!r} (referenced from {child_path}) not found; "
        f"tried {[str(c) for c in candidates]}")


def load_config(path: str | os.PathLike) -> dict:
    """Load a config file with its ``base_config`` chain resolved."""
    path = Path(path)
    cfg = loads(path.read_text())
    if not isinstance(cfg, dict):
        raise TypeError(f"config {path} must be a JSON object")
    base_ref = cfg.pop("base_config", None)
    if base_ref:
        cfg = override_config(load_config(_resolve_base_path(base_ref, path)),
                              cfg)
    return cfg


def save_config(path: str | os.PathLike, cfg: dict) -> None:
    """Write a resolved config as plain JSON."""
    Path(path).write_text(json.dumps(cfg, indent=2))
