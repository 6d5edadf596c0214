"""Converted-checkpoint cache, the counterpart of JAX ``checkpoints/cache.py``.

Converting an original checkpoint (loading it, sniffing the family, key
renames and transposes) of a multi-GB model costs seconds. This module keeps
the *converted* module state dict (``DPTModel.net.state_dict()``, float32)
beside the original file, with the source's fingerprint (size and mtime, as
the JAX package keys its cache), the config and the family in a JSON meta
entry, so a changed checkpoint invalidates it.

The file is ``<name>.dpt_torch_cache.npz``, never the JAX package's
``<name>.dpt_cache.npz``: the two hold different trees (a module state dict
here, a parameter pytree there), and the JAX loader checks only the
fingerprint, so it would take a file of the other kind for its own. The meta
carries ``FORMAT``, and ``load_converted`` refuses any file without it."""

from __future__ import annotations

import json
import os
import os.path as osp
import zipfile

import numpy as np
import torch

FORMAT = "muggled_dpt_tpu_torch/net_state_dict/1"
SUFFIX = ".dpt_torch_cache.npz"


def _fingerprint(path: str) -> str:
    st = os.stat(path)
    return f"{st.st_size}-{int(st.st_mtime)}"


def cache_path_for(checkpoint_path: str) -> str:
    return osp.splitext(checkpoint_path)[0] + SUFFIX


def save_converted(checkpoint_path: str, model_type: str, config_dict: dict, state_dict: dict) -> str:
    """Write the converted (family, config, float32 state dict) cache beside
    the checkpoint. Returns the cache path."""
    meta = {"format": FORMAT, "fingerprint": _fingerprint(checkpoint_path), "model_type": model_type,
            "config": _json_safe(config_dict)}
    arrays = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in state_dict.items()}
    out = cache_path_for(checkpoint_path)
    np.savez(out, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    return out


def load_converted(checkpoint_path: str):
    """(model_type, config_dict, float32 state dict of CPU tensors) from a
    cache of this package whose fingerprint matches the checkpoint, else None."""
    cache = cache_path_for(checkpoint_path)
    if not osp.exists(cache):
        return None
    try:
        with np.load(cache) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            if meta.get("format") != FORMAT or meta.get("fingerprint") != _fingerprint(checkpoint_path):
                return None
            state_dict = {k: torch.from_numpy(data[k]) for k in data.files if k != "__meta__"}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):  # unreadable or truncated: convert again
        return None
    return meta["model_type"], meta["config"], state_dict


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj
