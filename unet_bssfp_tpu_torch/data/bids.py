"""Minimal BIDS entity parser + file index (the port's own copy of
``unet_bssfp_tpu/data/bids.py``).

BIDS filenames are ``key-value`` pairs joined by underscores with a trailing
suffix (``sub-X_ses-Y_..._desc-Z_<suffix>.nii.gz``); a filesystem walk
answers every query the pipeline makes (subject, suffix, desc,
scope=derivatives).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


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

    def get_subjects(self) -> List[str]:
        """Every subject label of the indexed files, sorted."""
        return sorted({ents["subject"] for ents in map(parse_entities, self.files)
                       if "subject" in ents})

    def get(
        self,
        scope: Optional[str] = None,
        subject: Optional[str] = None,
        suffix: Optional[str] = None,
        desc: Optional[str] = None,
        extension: Optional[str] = None,
    ) -> List[str]:
        """Sorted paths matching every given entity (``extension`` matches
        the end of the path)."""
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
            if extension is not None and not p.endswith(extension):
                continue
            out.append(p)
        return sorted(out)


def subject_split(subjects: Sequence[str], val_split: float, test_split: float,
                  seed: int) -> Tuple[List[str], List[str], List[str]]:
    """Seeded subject-level train/val/test split (reference
    ``src/data_module.py:70-75``, torch ``random_split`` over subject ids).

    Each split gets the floor of its fraction of ``n``; the remainder goes
    round-robin from the first split (torch's rule). The order is
    ``np.random.default_rng(seed).permutation(n)``, as the JAX package
    draws it, so both packages split a cohort the same way."""
    n = len(subjects)
    fracs = [1.0 - val_split - test_split, val_split, test_split]
    lengths = [int(np.floor(n * f)) for f in fracs]
    for i in range(n - sum(lengths)):
        lengths[i % 3] += 1
    perm = np.random.default_rng(seed).permutation(n)
    subjects = list(subjects)
    out, start = [], 0
    for ln in lengths:
        out.append([subjects[i] for i in perm[start:start + ln]])
        start += ln
    return out[0], out[1], out[2]
