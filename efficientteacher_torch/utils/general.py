"""Small host-side utilities (copies from
`efficientteacher_tpu/utils/general.py`; parity: reference utils/general.py
misc)."""

from __future__ import annotations

import math
import re
from pathlib import Path


def increment_path(path, exist_ok: bool = False, sep: str = "",
                   mkdir: bool = False) -> Path:
    """runs/exp -> runs/exp2, exp3... (reference general.py:1230-1246)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        suffix = path.suffix
        path = path.with_suffix("")
        dirs = [str(p) for p in path.parent.glob(f"{path.name}{sep}*")]
        matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path.name), d)
                   for d in dirs]
        nums = [int(m.groups()[0]) for m in matches if m]
        n = max(nums) + 1 if nums else 2
        path = Path(f"{path}{sep}{n}{suffix}")
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def check_img_size(imgsz: int, s: int = 32, floor: int = 0) -> int:
    """Round image size to a stride multiple (reference general.py:313-322)."""
    new_size = max(math.ceil(imgsz / s) * s, floor)
    return int(new_size)
