"""Shared metadata-schema resolution for benchmark/demo jsonl items.

One item line can be in EITHER schema: ours ({"image", "prompt"}) or the
reference's raw dataset items — demo data.jsonl uses
{"key": path-sans-ext, "instruction"} (src/Qwen-Image-Edit-2509/main.py:70,66)
and the eval preprocessor dumps items verbatim with images at
img/{key}.png (data/preprocess.py:39,43).  Both the CLI and the
VIEScore harness read these files; resolving the schema in one place keeps
their semantics from drifting.

The port's own copy of `regione_tpu/utils/metadata.py`, held equal to it
by tests/test_torch_core_config.py."""

from __future__ import annotations

import os
from pathlib import Path


def resolve_item(item: dict, img_dir=None) -> tuple[str, str]:
    """(image path, prompt) from a metadata line in either schema.

    ``img_dir`` roots relative paths (the full relative path is kept —
    an "image" with subdirectories must not be flattened to its
    basename).  A present-but-empty prompt is returned as-is; only a
    missing/None prompt raises."""
    if item.get("image") is not None:
        path = item["image"]
    elif item.get("key") is not None:
        path = f"{item['key']}.png"
    else:
        raise KeyError(f"metadata item has neither 'image' nor 'key': "
                       f"{sorted(item)}")
    if img_dir is not None and not os.path.isabs(path):
        path = str(Path(img_dir) / path)
    prompt = item.get("prompt")
    if prompt is None:
        prompt = item.get("instruction")
    if prompt is None:
        raise KeyError(f"metadata item has neither 'prompt' nor "
                       f"'instruction': {sorted(item)}")
    return path, prompt


def item_key(item: dict, path: str) -> str:
    """Output key for an item: its explicit "key" else the image stem."""
    return item.get("key") or Path(path).stem
