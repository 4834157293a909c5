"""MOJO-v2 artifact reader: a zip of ``model.json`` metadata plus an
``arrays.npz`` of numpy arrays.

The JAX package writes these artifacts (its ``export_mojo``); a tree
ensemble carries the flattened serving arrays (``flat_*``), the
optional per-node ``flat_cover`` that TreeSHAP needs, ``init_score``
and ``enum_mask``. This module only reads them.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

__all__ = ["MOJO_FORMAT", "read_mojo_parts"]

# format 2: tree ensembles carry the flattened serving arrays (flat_*)
_FORMAT = "h2o_kubernetes_tpu/mojo/2"
_READABLE_FORMATS = ("h2o_kubernetes_tpu/mojo/1", _FORMAT)

# the format a scorer replica serves (v1 artifacts have no flat arrays)
MOJO_FORMAT = _FORMAT


def read_mojo_parts(path, want_nested: bool = False
                    ) -> tuple[dict, dict, dict]:
    """(meta, arrays, nested) of a mojo artifact (a path or a binary
    file-like object). ``nested`` holds the inner ``*.mojo`` blobs of a
    stackedensemble artifact when ``want_nested``; empty otherwise."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("model.json"))
        if meta.get("format") not in _READABLE_FORMATS:
            raise ValueError(f"not a {_FORMAT} artifact "
                             f"(format={meta.get('format')!r})")
        with np.load(io.BytesIO(z.read("arrays.npz"))) as npz:
            arrays = {k: npz[k] for k in npz.files}
        nested = {}
        if want_nested:
            nested = {n: z.read(n) for n in z.namelist()
                      if n.endswith(".mojo")}
    return meta, arrays, nested
