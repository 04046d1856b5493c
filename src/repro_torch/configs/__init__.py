"""Architecture registry: ``--arch <id>`` resolves here.

Each module holds CONFIG (the exact published numbers) and smoke()
(a reduced same-family config for CPU tests). The port keeps its own copy
of ``repro.configs`` (data only), so the registry resolves every id; the
model code serves the dense GQA ids (qwen3-4b, yi-6b, qwen2.5-32b,
h2o-danube-1.8b) and raises ``NotImplementedError`` for the others.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "deepseek-v3-671b",
    "arctic-480b",
    "xlstm-1.3b",
    "qwen3-4b",
    "qwen2.5-32b",
    "h2o-danube-1.8b",
    "yi-6b",
    "whisper-base",
    "phi-3-vision-4.2b",
    "recurrentgemma-2b",
]

_MOD = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
        for a in ARCH_IDS}


def get_config(arch_id: str):
    if arch_id not in _MOD:
        raise KeyError(f"unknown arch {arch_id!r}; choices: {ARCH_IDS}")
    return importlib.import_module(_MOD[arch_id]).CONFIG


def get_smoke_config(arch_id: str):
    return importlib.import_module(_MOD[arch_id]).smoke()
