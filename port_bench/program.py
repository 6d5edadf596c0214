"""The system under test: ``muggled_dpt_tpu_torch`` built from original-layout
weights, and one timed step through its facade entry.

The weights go through the port's own converter (``checkpoints.<family>``:
``get_config_from_state_dict`` and ``convert_state_dict``) and assembly
(``make_dpt._assemble_converted``): the steps of ``make_dpt_from_state_dict``
after its file read. The configuration file names the converter module and
the model type."""

from __future__ import annotations

import importlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def build(config: dict, state_dict: dict, device):
    """A ``DPTModel`` of ``config`` from an original-layout state dict."""
    from muggled_dpt_tpu_torch import make_dpt

    converter = importlib.import_module(config["converter"])
    port_config = converter.get_config_from_state_dict(state_dict, config.get("enable_cache", True), True)
    converted = converter.convert_state_dict(state_dict, port_config)
    return make_dpt._assemble_converted(config["model_type"], port_config, converted, DTYPES[config["dtype"]], device)


def port_config_matches(model, config: dict) -> list:
    """The keys that the port read from the weights (``model.config``) and
    the configuration file both hold, where their values differ, as
    messages; a message too where they share no key. Each family's converter
    names its widths its own way, so the shared keys are the ones compared."""
    shared = sorted(set(model.config) & set(config))
    if not shared:
        return [f"the port's config and the file share no key (port {sorted(model.config)})"]

    def plain(v):
        return list(v) if isinstance(v, (list, tuple)) else v

    return [f"{k}: port {model.config[k]} file {config[k]}" for k in shared if plain(model.config[k]) != plain(config[k])]
