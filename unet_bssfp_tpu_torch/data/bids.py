"""Minimal BIDS entity parser + file index (the port's own copy of
``unet_bssfp_tpu/data/bids.py``).

BIDS filenames are ``key-value`` pairs joined by underscores with a trailing
suffix (``sub-X_ses-Y_..._desc-Z_<suffix>.nii.gz``); a filesystem walk
answers every query the pipeline makes (subject, suffix, desc,
scope=derivatives).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


def parse_entities(path: str) -> Dict[str, str]:
    """Parse BIDS entities from a filename.

    ``sub-001_ses-01_desc-normtensor_dwi.nii.gz`` →
    ``{'subject': '001', 'session': '01', 'desc': 'normtensor',
       'suffix': 'dwi', 'extension': '.nii.gz'}``
    """
    name = os.path.basename(path)
    ext = ""
    for candidate in (".nii.gz", ".nii", ".json", ".tsv", ".txt"):
        if name.endswith(candidate):
            ext = candidate
            name = name[: -len(candidate)]
            break
    parts = name.split("_")
    ents: Dict[str, str] = {"extension": ext}
    key_map = {"sub": "subject", "ses": "session"}
    for part in parts[:-1]:
        if "-" in part:
            k, v = part.split("-", 1)
            ents[key_map.get(k, k)] = v
    # Last underscore-token without a dash is the suffix.
    if "-" not in parts[-1]:
        ents["suffix"] = parts[-1]
    elif parts[-1]:
        k, v = parts[-1].split("-", 1)
        ents[key_map.get(k, k)] = v
    return ents


class BIDSIndex:
    """Index of one BIDS tree (optionally with a derivatives scope added,
    mirroring ``BIDSLayout(...).add_derivatives(...)``)."""

    def __init__(self, root: str):
        self.root = root
        self.files: List[str] = []
        self.scopes: Dict[str, str] = {}  # path -> scope name
        self._walk(root, "raw")

    def _walk(self, root: str, scope: str) -> None:
        for dirpath, dirnames, filenames in os.walk(root):
            # Don't descend into derivatives from the raw walk.
            if scope == "raw" and "derivatives" in dirnames:
                dirnames.remove("derivatives")
            for fn in sorted(filenames):
                if fn.endswith(".nii.gz") or fn.endswith(".nii"):
                    p = os.path.join(dirpath, fn)
                    self.files.append(p)
                    self.scopes[p] = scope

    def add_derivatives(self, deriv_dir: str) -> None:
        scope = os.path.basename(deriv_dir.rstrip("/"))
        self._walk(deriv_dir, scope)

    def get(
        self,
        scope: Optional[str] = None,
        subject: Optional[str] = None,
        suffix: Optional[str] = None,
        desc: Optional[str] = None,
    ) -> List[str]:
        out = []
        for p in self.files:
            if scope is not None and self.scopes.get(p) != scope:
                continue
            ents = parse_entities(p)
            if subject is not None and ents.get("subject") != subject:
                continue
            if suffix is not None and ents.get("suffix") != suffix:
                continue
            if desc is not None and ents.get("desc") != desc:
                continue
            out.append(p)
        return sorted(out)

